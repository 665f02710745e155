"""The model tier of the port: GQA, sliding-window, MLA, RG-LRU and Mamba
decoders with dense, MoE or no FFNs, cross-attention over an encoder's
output or vision embeddings, prefill, decode and training, on one device
or, every mixer and FFN, over a mesh (``sharding/``).
"""
