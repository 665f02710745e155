"""Architecture registry: ``--arch <id>`` resolution for every launcher,
benchmark and test.

The port's copy of ``repro/configs/registry.py``, pointing at its own
config modules (plain data, no JAX)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
}

ARCH_IDS = tuple(_MODULES)

# assigned input shapes: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def cells(include_skips: bool = False):
    """All (arch, shape) dry-run cells. long_500k only for sub-quadratic
    archs (full-attention skips are recorded in DESIGN.md); decode shapes
    skip nothing here because every assigned arch has a decoder."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape == "long_500k" and not cfg.subquadratic:
                if include_skips:
                    out.append((arch, shape, "skip: full attention at 512k"))
                continue
            out.append((arch, shape, None) if include_skips else (arch, shape))
    return out


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small widths, few
    layers/experts, tiny vocab — same block structure."""
    import dataclasses

    cfg = get_config(arch)
    scale = {
        "d_model": 64,
        "n_heads": 4,
        "n_kv_heads": min(cfg.n_kv_heads, 2),
        "d_ff": 128 if cfg.d_ff else 0,
        "vocab": 512,
        "d_head": 16,
        "grad_accum": 1,
        "remat": False,
    }
    if cfg.n_experts:
        # capacity 4.0: smoke tests assert exact decode==forward equivalence,
        # which requires no capacity drops (production keeps 1.25).
        scale.update(n_experts=8, moe_topk=2, d_expert=32,
                     n_shared_experts=min(cfg.n_shared_experts, 1),
                     moe_capacity_factor=4.0)
    if cfg.mla:
        scale.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                     qk_rope_dim=8, v_head_dim=16)
    if cfg.ssm_state:
        scale.update(ssm_state=8, ssm_conv=4, ssm_expand=2)
    if cfg.lru_width:
        scale.update(lru_width=64)
    if cfg.sliding_window:
        scale.update(sliding_window=32)
    if cfg.n_vision_tokens:
        scale.update(n_vision_tokens=16)

    # shrink the segment stack: keep structure, one period each (plus any
    # remainder segment) so every block type is exercised.
    segs = tuple((period, 1) for period, _ in cfg.segments)
    scale["segments"] = segs
    scale["n_layers"] = sum(len(p) for p, _ in segs)
    if cfg.encoder_segments:
        esegs = tuple((period, 1) for period, _ in cfg.encoder_segments)
        scale["encoder_segments"] = esegs
        scale["encoder_layers"] = sum(len(p) for p, _ in esegs)
    return dataclasses.replace(cfg, **scale)
