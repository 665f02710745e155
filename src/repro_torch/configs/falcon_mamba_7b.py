"""falcon-mamba-7b — pure Mamba1 SSM, attention-free.
[arXiv:2410.05355; unverified]

Attention-free -> sub-quadratic -> runs the long_500k shape. Mamba blocks
have no separate MLP (d_ff=0); the mixer itself carries the expansion.
"""
from repro_torch.configs.base import ModelConfig, BlockSpec

MAMBA = BlockSpec("mamba", "none")

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    segments=(((MAMBA,), 64),),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    subquadratic=True,
    grad_accum=8,
)
