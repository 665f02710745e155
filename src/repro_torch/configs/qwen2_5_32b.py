"""qwen2.5-32b — dense GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig, ATTN_DENSE

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    segments=(((ATTN_DENSE,), 64),),
    attn_bias=True,
    rope_theta=1000000.0,
    grad_accum=16,
)
