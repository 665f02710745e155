"""The sort cells: ``repro_torch.sort`` in a closed loop.

One client sorts the pool's inputs in turn, each call timed from its
start until its outputs are on the card (CUDA events), the window on the
host's clock. On several ranks (the traffic's ``ranks``) every rank
calls ``repro_torch.sort(x_local, where=(mesh, "data"))`` on its shard,
rank 0 decides each turn whether the window goes on (one broadcast of a
flag), and rank 0's calls count every rank's keys.

A run with ``--trace 1`` sorts with ``SortLimits(trace=True)`` for the
first three quarters of the window (the phase spans, fenced), then
profiles ``profile_calls`` untraced sorts on the card alone (the busy and
idle time, ``benchlib.profile``), then one more with the operators'
shapes recorded (the rooflines).

The check: a sample of the window's sorts, drawn from the seed, keeps its
outputs; once the window has closed the inputs are made again from the
seed and sorted by the plain reference (``reference/sort.py``), and every
key (and, for ``want="order"``, every index) is compared.
"""
from __future__ import annotations

import dataclasses
import sys
import time

from benchlib import profile as prof
from benchlib import stats, timing, traffic
from benchlib.harness import Reading


def _trace_record(out) -> dict:
    """The per-layer readings of one traced sort: the phase spans' seconds
    by name, the trace's wall, the counts' imbalance, the ladder's retries."""
    tr = out.meta.trace
    spans: dict = {}
    for s in tr.spans:
        spans[s.name] = spans.get(s.name, 0.0) + s.duration
    return {"spans": spans, "traced_s": tr.duration(), "counts": [int(c) for c in out.counts],
            "retries": int(out.meta.retries)}


def run(ctx) -> Reading:
    import torch

    import repro_torch
    from repro_torch.core.planner import SortLimits
    from repro_torch.core.splitters import SortConfig

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    traffic.check_loop(tr)
    n = cfg["keys_per_card"]
    want = tr["want"]
    limits = SortLimits(n_procs=cfg["n_procs"], stream_threshold=cfg["stream_threshold"])
    sort_cfg = SortConfig(**cfg["sort"])
    where = None
    if ctx.world > 1:
        from torch.distributed.device_mesh import DeviceMesh

        mesh = DeviceMesh(dev.type, torch.arange(ctx.world), mesh_dim_names=("data",))
        where = (mesh, "data")

    def call(x, traced: bool):
        out = repro_torch.sort(x, want=want, where=where, config=sort_cfg,
                               investigator=cfg["investigator"],
                               limits=dataclasses.replace(limits, trace=traced), device=dev)
        keys = out.keys
        order = out.order() if want == "order" else None
        return out, keys, order

    flag = torch.zeros(1, dtype=torch.int32, device=dev)

    def agree(go: int) -> int:
        """Rank 0's decision, on every rank."""
        if ctx.world == 1:
            return go
        import torch.distributed as dist

        flag.fill_(go)
        dist.broadcast(flag, 0)
        return int(flag.item())

    ctx.mark("imports done")
    pool = [traffic.sort_input(tr, n, ctx.seed, i, ctx.rank, dev) for i in range(tr["pool"])]
    for i in range(2):  # the first builds the kernels; the second runs warm
        call(pool[i % len(pool)], False)
        ctx.mark(f"warm-up sort {i} done")
    timing.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    timer = timing.CallTimer(dev)
    sample = stats.Reservoir(ctx.workload["check"]["sample"], stats.derive(ctx.seed, "sample"))
    calls, per_call = [], []
    items = n * ctx.world
    t0 = time.perf_counter()
    traced_until = t0 + 0.75 * ctx.seconds if ctx.trace else t0
    i = 0

    def one(traced: bool):
        nonlocal i
        idx = i % len(pool)
        timer.start()
        try:
            out, keys, order = call(pool[idx], traced)
            ok = True
        except Exception as e:  # a failed call counts in `failed` and misses every limit
            print(f"call {i} failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
            out = keys = order = None
            ok = False
        timer.stop()
        latency = timer.seconds() if ok else float("inf")
        calls.append({"latency_s": latency, "items": items, "ok": ok})
        if ok:
            block = out.block
            sample.offer(lambda: (idx, keys, order, None if block is None
                                  else (block.start, block.stop)))
            if traced:
                per_call.append(_trace_record(out))
        i += 1

    while agree(int(time.perf_counter() < traced_until)):
        one(True)
    holder = shaped = None
    if ctx.trace:
        with prof.traced(dev) as holder:
            for _ in range(tr["profile_calls"]):
                one(False)
        with prof.traced(dev, shapes=True) as shaped:
            one(False)
    else:
        while agree(int(time.perf_counter() - t0 < ctx.seconds)):
            one(False)
    timing.sync(dev)
    window_s = time.perf_counter() - t0
    peak = timing.memory_peak(dev)
    del pool

    r = Reading(setup_s=setup_s, window_s=window_s, calls=calls, per_call=per_call,
                memory_peak_bytes=peak, device_kind=timing.device_kind(dev))
    if holder is not None:
        r.profile, r.shapes = holder.profile, shaped.profile
        r.busy_s, r.window_traced_s = _mean_over_ranks(ctx, holder.profile)
    ctx.mark(f"window closed after {len(calls)} sorts")
    _check(ctx, r, sample.items, n)
    ctx.mark("check done")
    return r


def _mean_over_ranks(ctx, p) -> tuple:
    busy, window = p.busy_s, p.window_s
    if ctx.world > 1:
        import torch
        import torch.distributed as dist

        t = torch.tensor([busy, window], dtype=torch.float64, device=ctx.device)
        dist.all_reduce(t)
        busy, window = (t / ctx.world).tolist()
    return busy, window


def _check(ctx, r: Reading, kept: list, n: int) -> None:
    """Every key (and index) of the sampled sorts against the reference,
    summed over the ranks; on several ranks the blocks must also tile the
    global result in rank order."""
    import torch

    from reference import sort as ref

    want = ctx.traffic["want"]
    dev = ctx.device
    bad_keys = bad_order = 0
    for idx, keys, order, block in sorted(kept, key=lambda k: k[0]):
        shards = [traffic.sort_input(ctx.traffic, n, ctx.seed, idx, rank, dev)
                  for rank in range(ctx.world)]
        x = torch.cat(shards) if len(shards) > 1 else shards[0]
        del shards
        want_keys, want_order = ref.sort(x, want)
        lo, hi = (0, x.numel()) if block is None else block
        bad_keys += ref.mismatches(keys, want_keys[lo:hi])
        if want == "order":
            bad_order += ref.mismatches(order, want_order[lo:hi])
        del x, want_keys, want_order
    blocks = [b for _, _, _, b in sorted(kept, key=lambda k: k[0])]
    compared = torch.tensor([len(kept), bad_keys, bad_order], dtype=torch.int64, device=dev)
    if ctx.world > 1:
        import torch.distributed as dist

        spans = [None] * ctx.world
        dist.all_gather_object(spans, blocks)
        # rank by rank, each sample's blocks must start where the last ended
        for s in range(len(blocks) if ctx.rank == 0 else 0):
            at = 0
            for rank in range(ctx.world):
                lo, hi = spans[rank][s]
                compared[1] += abs(lo - at)
                at = hi
            compared[1] += abs(n * ctx.world - at)
        dist.all_reduce(compared[1:])
    limits = ctx.workload["check"]["limits"]
    r.compared = int(compared[0])
    r.checks.append(("keys_mismatched", int(compared[1]), limits["keys_mismatched"]))
    if want == "order":
        r.checks.append(("order_mismatched", int(compared[2]), limits["order_mismatched"]))
