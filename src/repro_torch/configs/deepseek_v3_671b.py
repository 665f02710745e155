"""deepseek-v3-671b — MLA attention, 1 shared + 256 routed experts top-8,
3 dense layers then 58 MoE. [arXiv:2412.19437; hf]

MTP (multi-token prediction) is a training-objective add-on and is noted
as out of scope in DESIGN.md §Arch-applicability; the backbone, MLA and
MoE stack are implemented in full.

Scale notes (DESIGN.md §5): expert weights are sharded over
("data","model") = 256 ways (1 expert/device on the single-pod mesh);
optimizer uses Adafactor with bf16 accumulators so states fit v5e HBM
(DeepSeek-V3 itself trained with bf16 moments / fp8 compute).
"""
from repro_torch.configs.base import ModelConfig, BlockSpec

DENSE = BlockSpec("mla", "dense")
MOE = BlockSpec("mla", "moe")

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,  # dense layers
    vocab=129280,
    segments=(((DENSE,), 3), ((MOE,), 58)),
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    moe_topk=8,
    d_expert=2048,
    moe_capacity_factor=1.25,
    optimizer="adafactor",
    opt_state_dtype="bfloat16",
    grad_accum=16,
)
