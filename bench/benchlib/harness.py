"""The run: argument parsing, the look for the card, the rank processes,
the metrics, the guard against JAX, and the result line.

``bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
finds the cell's pieces by name (``registry``), runs its driver
(``benchlib/drivers/<kind>.py``), reads every metric the cell reports
through its reader (``bench/metrics/<metric>.py``) and prints one JSON
object as the last line of standard output. A cell of several ranks
(its traffic's ``ranks``) runs one process a card: this process is rank
0 and starts the others, which run the same driver and print nothing.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from benchlib import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Reading:
    """What a driver measured, for the readers of ``bench/metrics/``.

    setup_s     from process start to the first timed call
    window_s    the measured window on the host's clock: from its start
                to the end of the last call that began in it
    calls       one dict a call of the window: ``latency_s`` (inf for a
                failed one), ``items`` (keys or prompt tokens), ``ok``
    per_call    per-layer readings of the traced run's calls (spans,
                imbalance, retries, the dispatch's device time)
    profile     ``profile.Profile`` of the stretch traced on the card
                alone, or None
    shapes      ``profile.Profile`` of the stretch traced with the
                operators' shapes (the rooflines' numerators), or None
    busy_s, window_traced_s   the card's busy seconds in ``profile``'s
                stretch (averaged over the ranks) and the stretch's length
    device_kind, memory_peak_bytes   the card's name, its allocator's peak
    extra       anything else a driver hands its readers
    checks      (name, value, limit) of each number compared; ``compared``
                the answers compared
    """

    def __init__(self, **kw):
        self.setup_s = None
        self.window_s = None
        self.calls: list = []
        self.per_call: list = []
        self.profile = None
        self.shapes = None
        self.extra: dict = {}
        self.checks: list = []  # (name, value, limit)
        self.compared = 0
        self.memory_peak_bytes = 0
        self.busy_s = None
        self.window_traced_s = None
        self.device_kind = None
        self.__dict__.update(kw)

    @property
    def attempted(self) -> int:
        return len(self.calls)

    @property
    def failed(self) -> int:
        return sum(1 for c in self.calls if not c["ok"])


class Run:
    """One run of a cell: its pieces and where it runs."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, t_start: float,
                 device_type: str = "cuda", rank: int = 0, world: int | None = None,
                 port: int | None = None):
        spec = registry.benchmark()
        self.spec = spec
        self.cell = registry.cell(spec, cell)
        self.name = cell
        self.config = registry.config(self.cell["config"])
        self.traffic = registry.traffic(self.cell["traffic"])
        self.workload = registry.workload(cell)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.t_start = t_start
        self.device_type = device_type
        self.rank = rank
        self.world = int(self.traffic.get("ranks", 1)) if world is None else world
        self.port = port
        self.store = None

    def mark(self, what: str) -> None:
        """Note on standard error how far the run has come, in seconds
        since the process started."""
        if self.rank == 0:
            print(f"[{time.perf_counter() - self.t_start:8.3f} s] {what}", file=sys.stderr,
                  flush=True)

    @property
    def device(self):
        import torch

        return torch.device(self.device_type, self.rank if self.device_type == "cuda" else None)

    def listen(self) -> None:
        """Rank 0's rendezvous store, listening before any other rank
        starts. Its port is the operating system's choice, made as the
        store binds it, so no other process can hold it."""
        import datetime

        import torch.distributed as dist

        self.store = dist.TCPStore("127.0.0.1", 0, self.world, True, wait_for_workers=False,
                                   timeout=datetime.timedelta(seconds=300))
        self.port = self.store.port

    def join(self) -> None:
        """Join the process group of a cell of several ranks (NCCL on
        cards, gloo on the CPU) through rank 0's store."""
        import datetime

        import torch
        import torch.distributed as dist

        if self.world == 1:
            return
        if self.device_type == "cuda":
            torch.cuda.set_device(self.rank)
        timeout = datetime.timedelta(seconds=300)
        if self.rank:
            self.store = dist.TCPStore("127.0.0.1", self.port, self.world, False,
                                       timeout=timeout)
        dist.init_process_group("nccl" if self.device_type == "cuda" else "gloo",
                                store=self.store, rank=self.rank, world_size=self.world,
                                timeout=timeout)

    def forbidden_everywhere(self) -> list:
        """The forbidden modules that any rank's process holds, on rank 0
        (every rank calls this before it leaves)."""
        found = loaded_forbidden()
        if self.world == 1:
            return found
        import torch.distributed as dist

        every = [None] * self.world
        dist.all_gather_object(every, found)
        return sorted({m for f in every for m in f})

    def leave(self) -> None:
        """Leave the process group; every rank waits for the others first,
        so that no rank's store goes while another still uses it."""
        import torch.distributed as dist

        if self.world > 1 and dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
        self.store = None


def _rank_argv(run: Run, r: int) -> list:
    return ["--workload", run.name, "--seed", str(run.seed), "--seconds", str(run.seconds),
            "--trace", str(int(run.trace)), "--rank", str(r), "--world", str(run.world),
            "--port", str(run.port)]


def execute(cell: str, seed: int, seconds: float, trace: bool, t_start: float, *,
            device_type: str = "cuda", rank_command: list | None = None, out=sys.stdout,
            err=sys.stderr) -> dict:
    """Run a cell as rank 0 and print its result; returns it. A cell of
    several ranks starts ranks 1.. as ``rank_command`` (this script by
    default) and waits for each to end."""
    run = Run(cell, seed, seconds, trace, t_start, device_type=device_type)
    procs = []
    if run.world > 1:
        run.listen()
        cmd = rank_command or [sys.executable, str(registry.BENCH / "run.py")]
        procs = [subprocess.Popen(cmd + _rank_argv(run, r), stdout=subprocess.DEVNULL)
                 for r in range(1, run.world)]
    try:
        run.join()
        reading = registry.driver(run.config["kind"]).run(run)
        found = run.forbidden_everywhere()
    finally:
        run.leave()
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    bad = [p.returncode for p in procs if p.returncode != 0]
    if bad:
        raise RuntimeError(f"a rank process exited with {bad}")
    return report(run, reading, found, out=out, err=err)


def rank_entry(argv, device_type: str = "cuda") -> int:
    """Ranks 1.. of a cell of several ranks: run the driver, print nothing."""
    a = parse(argv)
    run = Run(a.workload, a.seed, a.seconds, a.trace, time.perf_counter(),
              device_type=device_type, rank=a.rank, world=a.world, port=a.port)
    run.join()
    try:
        registry.driver(run.config["kind"]).run(run)
        run.forbidden_everywhere()
    finally:
        run.leave()
    return 0


def loaded_forbidden() -> list:
    """The modules of JAX or of the JAX package this process holds, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def report(run: Run, r: Reading, found: list, out=sys.stdout,
           err=sys.stderr) -> dict | None:
    """Check the guard (``found``: the forbidden modules any rank holds),
    read the cell's metrics, print the result line."""
    if found:
        print(f"refused: a process of this run loaded {found}, which the port must not use",
              file=err)
        return None
    metrics = {}
    for m in registry.metrics_of(run.spec, run.name, run.trace):
        value = registry.reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {name: {"value": value, "limit": limit} for name, value, limit in r.checks}
    correct = r.compared > 0 and all(v["value"] <= v["limit"] for v in checks.values())
    device = {"platform": "gpu" if run.device_type == "cuda" else run.device_type,
              "kind": r.device_kind, "count": run.world,
              "memory_peak_bytes": int(r.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": r.attempted, "failed": r.failed,
              "metrics": metrics, "device": device}
    if run.trace:
        device["busy_s"] = r.busy_s
        device["window_s"] = r.window_traced_s
        if r.profile is not None:
            result["breakdown"] = {"device_ops": r.profile.top_device_ops(),
                                   "idle_gaps": r.profile.idle_gaps()}
    result["checks"] = checks
    print(f"compared {r.compared} answers", file=err)
    for name, v in checks.items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result


def parse(argv):
    p = argparse.ArgumentParser(prog="bench/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: report the per-layer metrics from a traced run")
    for hidden in ("--rank", "--world", "--port"):
        p.add_argument(hidden, type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    a = parse(argv)
    spec = registry.benchmark()
    need = registry.cell(spec, a.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"refused: the cell {a.workload!r} needs {need} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if a.rank is not None:
        return rank_entry(argv)
    result = execute(a.workload, a.seed, a.seconds, bool(a.trace), t_start)
    return 0 if result is not None else 3
