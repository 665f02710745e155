"""starcoder2-15b — dense GQA, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig, ATTN_DENSE

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    segments=(((ATTN_DENSE,), 40),),
    norm="layernorm",
    norm_eps=1e-5,
    act="gelu",
    mlp_gated=False,
    mlp_bias=True,
    attn_bias=True,
    rope_theta=1000000.0,
    grad_accum=16,
)
