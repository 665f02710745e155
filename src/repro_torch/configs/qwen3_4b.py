"""qwen3-4b — dense GQA with per-head q/k RMS-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig, ATTN_DENSE

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab=151936,
    d_head=128,
    segments=(((ATTN_DENSE,), 36),),
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    grad_accum=8,
)
