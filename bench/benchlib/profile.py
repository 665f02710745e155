"""One traced stretch of a run, read from ``torch.profiler``'s trace.

``traced(device)`` profiles the card alone: its kernels, copies and
memsets and the host's CUDA runtime calls, which cost the host little,
so the stretch runs at the pace of an untraced one. Its bounds on the
trace's clock are those of the ``bench_window`` annotation around the
block where the trace holds it, else the ends of the first and the last
of the ``cudaDeviceSynchronize`` calls made around it. This is the
stretch that the device's busy and idle time are read from.
``traced(device, shapes=True)`` also records the host's operator calls
with their inputs' shapes: the rooflines' numerators, from a stretch of
its own, whose host cost leaves the idle stretch alone. On the CPU (the tests' runs) both record the
host. The trace is written to a temporary file, read back and deleted.
A ``Profile`` holds what the readers of ``bench/metrics/`` take from it:

* ``device``: every kernel, copy and memset on the card, (name, start,
  end) in seconds on the trace's clock;
* ``ops``: the host's operator calls, with their inputs' shapes and
  element types and the thread that made them (``shapes=True`` only);
* ``kernels``: every kernel on the card, (name, seconds, correlation id),
  and ``launches``: the runtime or driver call that launched each, by its
  correlation id, (thread, start); ``launched_by`` pairs a kernel with the
  operator whose call on the launching thread encloses its launch, on the
  host's clock alone, so a kernel is never judged by where the card's
  clock puts it against the host's;
* ``host``: every host event (runtime calls, and operators where they
  are recorded), for naming what the host did while the card was idle;
* ``window``: (start, end) of the traced stretch.

``busy_s`` is the length of the union of the device intervals inside the
window, never their sum: two kernels that overlap count once. A
collective's kernel (NCCL's) spins on the card while it waits for the
other ranks, so it is left out of the union: its time is idle unless
other work overlaps it.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

from benchlib import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW_NAME = "bench_window"
SYNC_NAME = "cudaDeviceSynchronize"


def is_collective(name: str) -> bool:
    return "nccl" in name.lower()


class Profile:
    def __init__(self, events: list, device_index: int):
        self.device, self.ops, self.host = [], [], []
        self.kernels, self.launches = [], {}
        self.window = None
        syncs = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e.get("dur", 0)) * 1e-6
            args = e.get("args", {})
            if cat in DEVICE_CATS:
                if int(args.get("device", device_index)) == device_index:
                    self.device.append((name, t0, t1))
                    if cat == "kernel":
                        self.kernels.append((name, t1 - t0, args.get("correlation")))
            elif cat in HOST_CATS:
                if cat == "user_annotation" and name == WINDOW_NAME:
                    self.window = (t0, t1)
                    continue
                self.host.append((name, t0, t1))
                if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                    self.launches[args["correlation"]] = (e.get("tid"), t0)
                if name == SYNC_NAME:
                    syncs.append(t1)
                if cat == "cpu_op":
                    self.ops.append({"name": name, "t0": t0, "t1": t1, "tid": e.get("tid"),
                                     "dims": args.get("Input Dims", []),
                                     "types": args.get("Input type", [])})
        if self.window is None and len(syncs) >= 2:
            self.window = (min(syncs), max(syncs))
        if self.window is None:
            raise RuntimeError(f"the trace has no {WINDOW_NAME!r} annotation and no two "
                               f"{SYNC_NAME} calls to bound it")

    def device_in_window(self) -> list:
        lo, hi = self.window
        return [(n, max(a, lo), min(b, hi)) for n, a, b in self.device if b > lo and a < hi]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def work_in_window(self) -> list:
        """The device intervals that do work: all but the collectives'."""
        return [(a, b) for n, a, b in self.device_in_window() if not is_collective(n)]

    @property
    def busy_s(self) -> float:
        return stats.union_length(self.work_in_window())

    def launched_by(self, match, op_names) -> list:
        """The kernels that ``match`` accepts, each with the innermost call
        of an operator named in ``op_names`` that encloses its launch on
        the launching thread: [(op, seconds)]. A kernel whose launch or
        operator the trace lacks is left out, and so is an operator none
        of whose kernels the trace holds."""
        calls = sorted((o for o in self.ops if o["name"] in op_names), key=lambda o: o["t0"])
        paired = []
        for name, seconds, corr in self.kernels:
            if not match(name) or corr not in self.launches:
                continue
            tid, at = self.launches[corr]
            inner = None
            for o in calls:
                if o["t0"] > at:
                    break
                if o["tid"] == tid and at <= o["t1"]:
                    inner = o
            if inner is not None:
                paired.append((inner, seconds))
        return paired

    def top_device_ops(self, k: int = 10) -> list:
        """The device operations that took most time, [[name, seconds]]."""
        by: dict = {}
        for n, a, b in self.device_in_window():
            by[n] = by.get(n, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The card's idle stretches inside the window, summed by what the
        host was doing when each began (the innermost host event covering
        its start: the latest started one that has not ended), longest
        first, [[name, seconds]]."""
        import bisect

        lo, hi = self.window
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by: dict = {}
        for a, b in stats.gaps(self.work_in_window(), lo, hi):
            name = "host: no traced event"
            i = bisect.bisect_right(starts, a) - 1
            for j in range(i, max(-1, i - 5000), -1):
                if host[j][2] > a:
                    name = host[j][0]
                    break
            by[name] = by.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


@contextlib.contextmanager
def traced(device, shapes: bool = False):
    """Profile the block; yields a holder whose ``.profile`` is set when
    the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchlib.timing import sync

    device = torch.device(device)
    holder = type("Traced", (), {"profile": None})()
    if device.type != "cuda":
        activities = [ProfilerActivity.CPU]
    elif shapes:
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    else:
        activities = [ProfilerActivity.CUDA]
    sync(device)
    with profile(activities=activities, record_shapes=shapes) as prof:
        sync(device)
        with record_function(WINDOW_NAME):
            yield holder
            sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    holder.profile = Profile(events, device.index or 0)
