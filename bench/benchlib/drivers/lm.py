"""The prefill cells: ``serve.engine.make_prefill`` on ``models.model.Model``
in a closed loop.

The model is built on the meta device from the configuration's file and
takes the benchmark's weights (``benchlib.lmweights``) as its
parameters, so the program's own seeded init makes nothing. One client
sends the pool's prompts in turn; a request's time runs from its issue
to its first token on the host: the prefill, then the argmax of the last
position's logits, copied to the host.

A run with ``--trace 1`` times the MoE dispatch's sort
(``core/keyenc.stable_argsort`` and ``core/merge.merge_padded_runs_kv``,
wrapped from here) with CUDA events on every request, and profiles the
last ``profile_calls`` requests on the card alone (``benchlib.profile``).

The check: a sample of the window's requests, drawn from the seed, keeps
its logits and served tokens; once the window has closed and the model is
freed, the reference (``reference/<reference>.py``) computes the same
prompts' last logits in float32 from weights made again from the seed.
Two numbers, each the largest over the sample's prompts, as a share of the root
mean square of the reference's logits: ``logit_err``, the root mean
square of the logits' difference, and ``token_gap``, how far the served
token's reference logit lies below the reference's best.
"""
from __future__ import annotations

import contextlib
import sys
import time

from benchlib import compare, counts, lmweights, registry, stats, timing, traffic
from benchlib import profile as prof
from benchlib.harness import Reading

MODEL_KEYS = ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "d_head", "rope_theta",
              "qk_norm", "attn_bias", "norm", "norm_eps", "act", "mlp_gated",
              "tie_embeddings", "n_experts", "n_shared_experts", "moe_topk", "d_expert",
              "moe_capacity_factor", "dtype", "flash_attention")


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file. The program
    always renormalises the top-k weights, so it refuses a configuration
    that says they are not."""
    from repro_torch.configs.base import BlockSpec, ModelConfig

    if cfg.get("n_experts") and not cfg["norm_topk_prob"]:
        raise ValueError("the program renormalises the top-k weights; this configuration's "
                         "norm_topk_prob is false")

    segments = tuple(((BlockSpec(b["mixer"], b["ffn"]),), b["count"]) for b in cfg["layers"])
    return ModelConfig(name=cfg["name"], family=cfg["family"],
                       n_layers=sum(b["count"] for b in cfg["layers"]), segments=segments,
                       **{k: cfg[k] for k in MODEL_KEYS if k in cfg})


def build_model(cfg: dict, seed: int, device):
    """The program's model holding the benchmark's weights."""
    from torch import nn

    from repro_torch.models.model import Model

    model = Model(model_config(cfg), device="meta")
    todo = dict(model.named_parameters())
    for g in range(lmweights.n_groups(cfg)):
        for name, t in lmweights.make_group(cfg, seed, g, device).items():
            want = todo.pop(name, None)
            if want is None or tuple(want.shape) != tuple(t.shape) or want.dtype != t.dtype:
                raise RuntimeError(f"the program's parameter {name} is "
                                   f"{None if want is None else (tuple(want.shape), want.dtype)}, "
                                   f"the benchmark makes {(tuple(t.shape), t.dtype)}")
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=False))
    if todo:
        raise RuntimeError(f"the program has parameters the benchmark does not make: "
                           f"{sorted(todo)[:5]}")
    return model


@contextlib.contextmanager
def dispatch_timed(device, spans: list):
    """Within it, every call of the MoE dispatch's sort (the argsort of
    expert ids and the merge of the received buckets) appends its
    ``CallTimer`` to ``spans``."""
    from repro_torch.core import keyenc
    from repro_torch.core import merge

    orig = keyenc.stable_argsort, merge.merge_padded_runs_kv

    def timed(fn):
        def wrapper(*args, **kwargs):
            t = timing.CallTimer(device)
            t.start()
            out = fn(*args, **kwargs)
            t.stop()
            spans.append(t)
            return out
        return wrapper

    keyenc.stable_argsort, merge.merge_padded_runs_kv = map(timed, orig)
    try:
        yield spans
    finally:
        keyenc.stable_argsort, merge.merge_padded_runs_kv = orig


def run(ctx) -> Reading:
    import torch

    from repro_torch.serve import engine

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    traffic.check_loop(tr)
    V = cfg["vocab"]
    ctx.mark("imports done")
    model = build_model(cfg, ctx.seed, dev)
    timing.sync(dev)
    ctx.mark("weights made")
    prefill = engine.make_prefill(model)
    prompts = traffic.prompts(tr, V, ctx.seed, dev)
    tokens_per_request = tr["batch"] * tr["prompt_tokens"]

    def request(idx):
        logits, caches = prefill({"tokens": prompts[idx]})
        del caches
        return logits, logits[:, -1, :V].argmax(-1).cpu()  # the first token, on the host

    for i in range(2):  # the first builds the kernels; the second runs warm
        request(i % len(prompts))
        ctx.mark(f"warm-up request {i} done")
    timing.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    sample = stats.Reservoir(ctx.workload["check"]["sample"], stats.derive(ctx.seed, "sample"))
    calls, per_call, dispatch = [], [], []
    i = 0

    def one():
        nonlocal i
        idx = i % len(prompts)
        first = len(dispatch)
        t = time.perf_counter()
        try:
            logits, token = request(idx)
            ok = True
        except Exception as e:  # a failed request counts in `failed`, misses every limit
            print(f"request {i} failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
            ok = False
        latency = time.perf_counter() - t if ok else float("inf")
        calls.append({"latency_s": latency, "items": tokens_per_request, "ok": ok})
        if ok:
            sample.offer(lambda: (idx, logits, token))
            if ctx.trace:
                per_call.append({"dispatch_s": sum(s.seconds() for s in dispatch[first:])})
        i += 1

    t0 = time.perf_counter()
    holder = None
    with dispatch_timed(dev, dispatch) if ctx.trace else contextlib.nullcontext():
        if ctx.trace:
            while time.perf_counter() - t0 < 0.75 * ctx.seconds:
                one()
            untraced = (time.perf_counter() - t0, len(calls))
            with prof.traced(dev) as holder:
                for _ in range(tr["profile_calls"]):
                    one()
        else:
            while time.perf_counter() - t0 < ctx.seconds:
                one()
            untraced = None
    timing.sync(dev)
    window_s = time.perf_counter() - t0
    peak = timing.memory_peak(dev)

    r = Reading(setup_s=setup_s, window_s=window_s, calls=calls, per_call=per_call,
                memory_peak_bytes=peak, device_kind=timing.device_kind(dev))
    r.extra["flops_per_request"] = counts.lm_prefill_flops(cfg, tr["prompt_tokens"], tr["batch"])
    if untraced is not None:
        r.extra["mfu_window_s"], r.extra["mfu_requests"] = untraced
    if holder is not None:
        r.profile = holder.profile
        r.busy_s, r.window_traced_s = holder.profile.busy_s, holder.profile.window_s
    kept = sample.items
    del model, prefill, prompts, dispatch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.mark(f"window closed after {len(calls)} requests")
    _check(ctx, r, kept)
    ctx.mark("check done")
    return r


def _check(ctx, r: Reading, kept: list) -> None:
    import torch

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    V = cfg["vocab"]
    ref = registry.reference(cfg["reference"])
    prompts = traffic.prompts(tr, V, ctx.seed, dev)  # made again: the program's are freed
    want = ref.last_logits(cfg, ctx.seed, torch.stack([prompts[idx] for idx, _, _ in kept]),
                           dev)
    err = gap = 0.0
    for j, (idx, logits, token) in enumerate(kept):
        for b in range(tr["batch"]):
            e, g = compare.logits(want[j, b], logits[b, -1, :V], token[b])
            err, gap = max(err, e), max(gap, g)
    limits = ctx.workload["check"]["limits"]
    r.compared = len(kept) * tr["batch"]
    r.checks += [("logit_err", err, limits["logit_err"]), ("token_gap", gap, limits["token_gap"])]

