"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts,
top-6; first layer dense. [arXiv:2401.06066; hf]

The MoE dispatch is the paper-technique showpiece: tokens are routed by a
distributed stable sort on expert ids (maximal key duplication — the
investigator's load-balance case). See repro/models/moe.py.
"""
from repro_torch.configs.base import ModelConfig, BlockSpec

DENSE = BlockSpec("attn", "dense")
MOE = BlockSpec("attn", "moe")

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,  # MHA
    d_ff=10944,  # dense first layer
    vocab=102400,
    segments=(((DENSE,), 1), ((MOE,), 27)),
    n_experts=64,
    n_shared_experts=2,
    moe_topk=6,
    d_expert=1408,
    moe_capacity_factor=1.25,
    grad_accum=8,
)
