"""whisper-base — encoder-decoder; conv audio frontend is a STUB
(``input_specs()`` provides precomputed frame embeddings for the encoder).
[arXiv:2212.04356; unverified]

Decoder layers carry self-attn (causal) + cross-attn to the encoder
output. Vocab padded to a 128-multiple for TP sharding (51865 -> 51968,
documented in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, BlockSpec

ENC = BlockSpec("attn", "dense", causal=False)
DEC = BlockSpec("attn", "dense", cross=True)

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,  # decoder layers; encoder counted separately
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    segments=(((DEC,), 6),),
    encoder_layers=6,
    encoder_segments=(((ENC,), 6),),
    norm="layernorm",
    norm_eps=1e-5,
    act="gelu",
    mlp_gated=False,
    mlp_bias=True,
    attn_bias=True,
    pos_embedding="sinusoidal",
    grad_accum=4,
)
