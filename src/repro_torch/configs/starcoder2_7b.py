"""starcoder2-7b — dense GQA, RoPE, LayerNorm + ungated GeLU MLP with
biases. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig, ATTN_DENSE

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    segments=(((ATTN_DENSE,), 32),),
    norm="layernorm",
    norm_eps=1e-5,
    act="gelu",
    mlp_gated=False,
    mlp_bias=True,
    attn_bias=True,
    rope_theta=1000000.0,
    grad_accum=8,
)
