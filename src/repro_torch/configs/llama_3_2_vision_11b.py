"""llama-3.2-vision-11b — text backbone with gated cross-attention image
layers every 5th layer. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision frontend is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings (B, n_vision_tokens, d_model) that
the cross-attention layers attend to.

40 layers = 8 periods of (self, self, self, cross+self, self).
"""
from repro_torch.configs.base import ModelConfig, BlockSpec

SELF = BlockSpec("attn", "dense")
CROSS = BlockSpec("attn", "dense", cross=True)

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    segments=(((SELF, SELF, SELF, CROSS, SELF), 8),),
    rope_theta=500000.0,
    n_vision_tokens=1600,  # stub patch-embedding count (~1601 in HF, padded)
    grad_accum=16,
)
