"""Model configuration schema shared by all 10 assigned architectures.

The port's own copy of ``repro/configs/base.py`` (plain dataclasses, no
JAX); only ``param_count`` differs: it counts the port's own model.

A config is a frozen dataclass; the layer stack is described as *segments*
of repeating block periods so the forward pass can ``lax.scan`` over
homogeneous stacks (compile-time critical at 512-way SPMD):

    segments = ( (period_of_BlockSpecs, count), ... )

e.g. recurrentgemma (Griffin 2:1 pattern, 38 layers):
    ( ((REC, REC, ATTN), 12), ((REC, REC), 1) )
deepseek-v3 (3 dense then 58 MoE):
    ( ((DENSE,), 3), ((MOE,), 58) )
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "local_attn", "mla", "rglru", "mamba", "none"]
Ffn = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One residual block: mixer + optional cross-attn + optional FFN."""

    mixer: Mixer = "attn"
    ffn: Ffn = "dense"
    cross: bool = False  # extra cross-attention mixer (enc-dec / VLM)
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    segments: tuple[tuple[tuple[BlockSpec, ...], int], ...] = ()

    # attention details
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_bias: bool = False
    sliding_window: int = 0  # for local_attn mixers
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"
    mlp_gated: bool = True
    mlp_bias: bool = False
    tie_embeddings: bool = False
    pos_embedding: str = "rope"  # rope | learned | sinusoidal | none

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_topk: int = 0
    d_expert: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # MLA (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    # RG-LRU (griffin)
    lru_width: int = 0

    # encoder-decoder (whisper) — encoder gets its own segment stack
    encoder_layers: int = 0
    encoder_segments: tuple = ()

    # VLM (llama-3.2-vision) — number of stub vision tokens for cross-attn
    n_vision_tokens: int = 0

    # capabilities
    supports_decode: bool = True
    subquadratic: bool = False  # may run long_500k

    # optimization switches (§Perf hillclimbs; baseline = False)
    decode_moe_ep: bool = False  # decode MoE via EP(data) x TP(model)
    flash_attention: bool = False  # two-level online-softmax attention
    hierarchical_a2a: bool = False  # 2-stage MoE exchange on 2-D EP
    seq_parallel: bool = False  # residual stream sharded over model (SP)

    # numerics / training defaults
    dtype: str = "bfloat16"
    grad_accum: int = 16
    optimizer: str = "adamw"  # adamw | adafactor
    opt_state_dtype: str = "float32"
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def layer_list(self) -> list[BlockSpec]:
        out: list[BlockSpec] = []
        for period, count in self.segments:
            out.extend(list(period) * count)
        assert len(out) == self.n_layers, (
            f"{self.name}: segments produce {len(out)} layers, expected {self.n_layers}"
        )
        return out

    def param_count(self) -> int:
        """Exact parameter count of the port's model, built on the meta
        device (no allocation)."""
        from repro_torch.models.model import Model  # lazy, avoids cycle

        return sum(p.numel() for p in Model(self, device="meta").parameters())

    def active_param_count(self) -> int:
        """Active-per-token params (MoE: routed experts count only top-k)."""
        total = self.param_count()
        if self.n_experts == 0:
            return total
        per_expert = 3 * self.d_model * self.d_expert
        n_moe_layers = sum(1 for s in self.layer_list() if s.ffn == "moe")
        inactive = (self.n_experts - self.moe_topk) * per_expert * n_moe_layers
        return total - inactive


# convenient canonical blocks
ATTN_DENSE = BlockSpec("attn", "dense")
LOCAL_DENSE = BlockSpec("local_attn", "dense")
REC_DENSE = BlockSpec("rglru", "dense")
MAMBA_ONLY = BlockSpec("mamba", "none")
MLA_DENSE = BlockSpec("mla", "dense")
MLA_MOE = BlockSpec("mla", "moe")
ATTN_MOE = BlockSpec("attn", "moe")
ENC_ATTN = BlockSpec("attn", "dense", causal=False)
DEC_CROSS = BlockSpec("attn", "dense", cross=True)
ATTN_CROSS_DENSE = BlockSpec("attn", "dense", cross=True)
