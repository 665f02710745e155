"""recurrentgemma-9b — Griffin hybrid: RG-LRU recurrent blocks + local
attention in a 2:1 pattern (two recurrent blocks per local-attn block).
[arXiv:2402.19427; unverified]

38 layers = 12 full (rec, rec, attn) periods + a (rec, rec) remainder.
Sub-quadratic (sliding-window attention + linear recurrence) -> runs the
long_500k shape.
"""
from repro_torch.configs.base import ModelConfig, BlockSpec

REC = BlockSpec("rglru", "dense")
LOC = BlockSpec("local_attn", "dense")

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,  # MQA
    d_ff=12288,
    vocab=256000,
    d_head=256,
    segments=(((REC, REC, LOC), 12), ((REC, REC), 1)),
    sliding_window=2048,
    lru_width=4096,
    act="gelu",
    rope_theta=10000.0,
    tie_embeddings=True,
    subquadratic=True,
    grad_accum=16,
)
