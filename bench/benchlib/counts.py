"""The table of peaks and the operations and bytes each kernel needs.

Peaks: NVIDIA's data sheet of the H100 SXM (dense, no sparsity) at its
full power limit of 700 W. A share of a roofline is the least time the
card could take (operations over the peak rate, or bytes over the peak
bandwidth) over the time the kernels took; it cannot pass 100% unless the
operations or bytes are counted too high or the time leaves out work.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}
H100 = PEAKS["NVIDIA H100 80GB HBM3"]

_DTYPE_BYTES = {
    "float": 4, "float32": 4, "int": 4, "int32": 4, "unsigned int": 4, "uint32": 4,
    "double": 8, "float64": 8, "long int": 8, "long": 8, "int64": 8,
    "c10::BFloat16": 2, "bfloat16": 2, "c10::Half": 2, "float16": 2,
}


def dtype_bytes(name: str) -> int:
    """Bytes of one element of a dtype as the profiler names it."""
    try:
        return _DTYPE_BYTES[name]
    except KeyError:
        raise ValueError(f"no element size known for the dtype {name!r}") from None


def bitonic_bytes(op: str, dims: list, dtypes: list) -> int:
    """Bytes one call of a bitonic op must move: every input byte read
    once, every output byte written once.

    ``op`` is the op's name without its namespace; ``dims`` and ``dtypes``
    are the tensor inputs' shapes and element types as the profiler
    records them (``record_shapes``). A row sort writes as much as it
    reads; a merge reads two (R, N) operands and writes one (R, 2N), so it
    too writes what it reads."""
    tensors = [(d, t) for d, t in zip(dims, dtypes) if d]
    read = 0
    for d, t in tensors:
        n = 1
        for s in d:
            n *= s
        read += n * dtype_bytes(t)
    if op not in ("sort_rows", "sort_rows_kv", "merge_rows", "merge_rows_kv"):
        raise ValueError(f"not a bitonic op: {op}")
    return 2 * read


def causal_attention_flops(B: int, S: int, T: int, H: int, dqk: int, dv: int) -> int:
    """FLOPs of causal attention of S queries over T keys: a score (2 dqk)
    and its share of PV (2 dv) for each kept pair, query i keeping keys
    0..i (at most T of them)."""
    full = max(0, min(S, T))
    pairs = full * (full + 1) // 2 + (S - full) * T
    return 2 * B * H * (dqk + dv) * pairs


def lm_prefill_flops(cfg: dict, S: int, B: int = 1) -> int:
    """The model FLOPs of one prefill of B prompts of S tokens through a
    configuration of ``bench/configs/`` (attention with dense or MoE
    feed-forward layers), counted from its published widths: the
    projections, the attention scores and their PV at the causal pairs,
    the dense MLP or the router with the top-k routed and the shared
    experts' SwiGLU, and the head at the last position only (a prefill
    serves one token). Norms, rope, softmax and the dispatch's data
    movement are not counted."""
    d, H, KV = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg.get("d_head") or d // H
    per_token = 0
    attn_pairs = 0
    for block in cfg["layers"]:
        for _ in range(block["count"]):
            per_token += 2 * d * (H * dh + 2 * KV * dh) + 2 * H * dh * d
            attn_pairs += causal_attention_flops(B, S, S, H, dh, dh)
            if block["ffn"] == "dense":
                per_token += 3 * 2 * d * cfg["d_ff"]
            elif block["ffn"] == "moe":
                active = cfg["moe_topk"] + cfg["n_shared_experts"]
                per_token += 2 * d * cfg["n_experts"] + active * 3 * 2 * d * cfg["d_expert"]
    head = 2 * d * cfg["vocab"] * B
    return B * S * per_token + attn_pairs + head
