"""``python -m repro_torch.obsctl`` — operator CLI for the observability plane.

Counterpart of ``repro/obsctl.py``, over the port's registry and flight
recorder. Subcommands (JSON/text in, JSON/text out):

* ``scrape [--out F] [--snapshot F] [--demo] [--device D]`` — render the
  process-wide Prometheus exposition (``--demo`` first drives a small
  in-process ``SortServer`` burst on ``--device``, "cuda" unless "cpu" is
  asked for, so a fresh process has something to show) and optionally
  dump a flight-recorder snapshot.
* ``diff A.txt B.txt`` — diff two scrape files sample-by-sample
  (counter deltas, gauge moves, appearing/vanishing series).
* ``slow SNAPSHOT[.json|dir] [-n N]`` — top-N slowest requests from a
  flight snapshot (or the newest ``incident_*.json`` in a directory),
  with the queue-wait/execute split and the linking flush_id.
* ``export SNAPSHOT [--out F] [--trace-id ID]`` — convert a snapshot's
  request/flush/trace records into Chrome/Perfetto trace-event JSON:
  one timeline row per request (queue_wait + execute slices), one row
  per coalesced flush (stage/sort/d2h slices), linked through
  ``flush_id`` args — "where did this request's 38 ms go" as a picture.
* ``bench-diff BASE.json FRESH.json [--tolerance T] [--gates-only]`` —
  compare two ``BENCH_<suite>.json``-shaped files op by op; exits nonzero
  on regressions beyond tolerance.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

#: ops whose wall time is a gated contract, with per-op tolerance
#: (fraction over baseline that counts as a regression). Ops not listed
#: here are informational: compared and printed, never fatal.
REGRESSION_GATES: dict[str, float] = {
    "api_dispatch_planner": 0.15,
    "api_dispatch_direct": 0.15,
    "api_materialize_device_decode": 0.25,  # ~100us op: noisier
    "api_multikey_packed": 0.15,
    "api_sort_sim_float32_262144": 0.15,
    "api_sort_sim_int32_262144": 0.15,
    "api_sort_stream_float32_262144": 0.15,
    "serve_async_batched": 0.20,
    "serve_lone_request_latency": 0.25,
}


# --------------------------------------------------------------- metrics
def parse_prom(text: str) -> dict[str, float]:
    """Prometheus text exposition -> {series: value}. Series is the full
    ``name{labels}`` string; non-numeric and comment lines are skipped."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            series, value = line.rsplit(None, 1)
            out[series] = float(value)
        except ValueError:
            continue
    return out


def diff_metrics(prev: dict[str, float],
                 curr: dict[str, float]) -> list[str]:
    """Human-readable per-series diff, changed series only."""
    lines = []
    for series in sorted(set(prev) | set(curr)):
        a, b = prev.get(series), curr.get(series)
        if a == b:
            continue
        if a is None:
            lines.append(f"+ {series} = {b:g}")
        elif b is None:
            lines.append(f"- {series} (was {a:g})")
        else:
            delta = b - a
            lines.append(f"  {series} {a:g} -> {b:g} ({delta:+g})")
    return lines


# ----------------------------------------------------------- bench diff
def _record_key(rec: dict) -> tuple:
    return (rec.get("op"), rec.get("size"), rec.get("dtype"),
            rec.get("backend"))


def compare_bench(base_records: list[dict], fresh_records: list[dict], *,
                  gates: dict[str, float] | None = None,
                  tolerance: float = 0.15,
                  min_us: float = 100.0) -> tuple[list[str], list[dict]]:
    """Compare two BENCH record lists op by op.

    Returns ``(report_lines, regressions)``. A record regresses when its
    op is gated (in ``gates``, default :data:`REGRESSION_GATES`; the
    per-op tolerance overrides ``tolerance``) and the fresh median
    exceeds baseline by more than the tolerance. Records are matched on
    (op, size, dtype, backend); entries timed under ``min_us`` on either
    side are reported but never fatal (that scale is scheduler noise,
    e.g. smoke-mode runs of big gates), as are records whose ``smoke``
    flags disagree (a smoke run is not comparable to a full run)."""
    gates = REGRESSION_GATES if gates is None else gates
    base = {_record_key(r): r for r in base_records}
    fresh = {_record_key(r): r for r in fresh_records}
    lines: list[str] = []
    regressions: list[dict] = []
    for key in sorted(set(base) & set(fresh), key=str):
        b, f = base[key], fresh[key]
        op = key[0]
        b_us, f_us = b.get("us_per_call"), f.get("us_per_call")
        if not b_us or f_us is None:
            continue
        ratio = f_us / b_us
        tol = gates.get(op, tolerance)
        gated = op in gates
        comparable = (b.get("smoke") == f.get("smoke")
                      and b_us >= min_us and f_us >= min_us)
        regressed = gated and comparable and ratio > 1.0 + tol
        tag = ("REGRESSED" if regressed
               else "gated" if gated and comparable
               else "skipped" if gated
               else "info")
        lines.append(f"{op:40s} {b_us:>12.1f} -> {f_us:>12.1f} us "
                     f"({ratio:5.2f}x)  [{tag}]")
        if regressed:
            regressions.append({"op": op, "base_us": b_us, "fresh_us": f_us,
                                "ratio": ratio, "tolerance": tol})
    for key in sorted(set(fresh) - set(base), key=str):
        lines.append(f"{key[0]:40s} (new op, no baseline)")
    return lines, regressions


def _load_bench(path: str) -> list[dict]:
    with open(path) as f:
        doc = json.load(f)
    return doc["records"] if isinstance(doc, dict) else doc


# --------------------------------------------------------- trace export
def _load_snapshot(path: str) -> dict:
    """A snapshot file, or the newest incident_*.json in a directory."""
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if n.startswith("incident_") and n.endswith(".json"))
        if not names:
            raise FileNotFoundError(f"no incident_*.json in {path}")
        path = os.path.join(path, names[-1])
    with open(path) as f:
        return json.load(f)


def snapshot_to_chrome(snap: dict, trace_id: str | None = None) -> list[dict]:
    """Flight snapshot -> Chrome trace events: one row per request
    (queue_wait/execute slices), one row per flush (stage/sort/d2h),
    plus any sampled full phase traces — all on one clock, linked via
    ``flush_id``/``trace_id`` args so Perfetto's flow queries can walk
    a request into the flush that served it."""
    requests = [r for r in snap.get("requests", [])
                if trace_id is None or r.get("trace_id") == trace_id]
    wanted_flushes = ({r.get("flush_id") for r in requests}
                      if trace_id is not None else None)
    flushes = [f for f in snap.get("flushes", [])
               if wanted_flushes is None or f.get("flush_id") in wanted_flushes]
    sampled = {t["trace_id"]: t["spans"] for t in snap.get("traces", [])}

    events: list[dict] = [{"name": "process_name", "ph": "M", "pid": 1,
                           "args": {"name": "repro_torch.serve flight recorder"}}]
    tid = 0

    def row(name: str) -> int:
        nonlocal tid
        tid += 1
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": name}})
        return tid

    # one shared epoch so request and flush rows line up
    t_bases = ([r["t_submit"] for r in requests if r.get("t_submit")]
               + [f["t0"] for f in flushes if f.get("t0")])
    t_base = min(t_bases) if t_bases else 0.0

    def us(t_s: float) -> float:
        return (t_s - t_base) * 1e6

    for f in flushes:
        r_tid = row(f"flush {f['flush_id']} ({f.get('kind')}, "
                    f"batch={f.get('batch')})")
        t = f.get("t0", t_base)
        phases = f.get("phases") or {}
        args = {"flush_id": f["flush_id"], "requests": f.get("requests"),
                "retries": f.get("retries"), "elems": f.get("elems")}
        total_ms = sum(phases.values())
        events.append({"name": "flush", "ph": "X", "pid": 1, "tid": r_tid,
                       "ts": us(t), "dur": total_ms * 1e3, "args": args})
        off = t
        for phase in ("stage_ms", "sort_ms", "d2h_ms"):
            dur_ms = phases.get(phase)
            if dur_ms is None:
                continue
            events.append({"name": phase[:-3], "ph": "X", "pid": 1,
                           "tid": r_tid, "ts": us(off), "dur": dur_ms * 1e3,
                           "args": {"flush_id": f["flush_id"]}})
            off += dur_ms / 1e3
    for r in requests:
        r_tid = row(f"req {r['trace_id']} ({r.get('kind')}, "
                    f"n={r.get('n')})")
        args = {"trace_id": r["trace_id"], "flush_id": r.get("flush_id"),
                "outcome": r.get("outcome"), "backend": r.get("backend"),
                "retries": r.get("retries")}
        t_submit, t_disp, t_done = (r.get("t_submit"), r.get("t_dispatch"),
                                    r.get("t_done"))
        if t_submit is not None and t_disp is not None:
            events.append({"name": "queue_wait", "ph": "X", "pid": 1,
                           "tid": r_tid, "ts": us(t_submit),
                           "dur": (t_disp - t_submit) * 1e6, "args": args})
        if t_disp is not None and t_done is not None:
            events.append({"name": "execute", "ph": "X", "pid": 1,
                           "tid": r_tid, "ts": us(t_disp),
                           "dur": (t_done - t_disp) * 1e6, "args": args})
        spans = sampled.get(r["trace_id"])
        if spans:
            # sampled phase spans use the tracing clock (perf_counter);
            # rebase them onto this request's execute window so the rows
            # line up even though the clocks differ
            s_base = min(s["t0"] for s in spans)
            shift = (t_disp if t_disp is not None else t_submit) or t_base
            for s in spans:
                events.append({
                    "name": s["name"], "ph": "X", "pid": 1, "tid": r_tid,
                    "ts": us(shift) + (s["t0"] - s_base) * 1e6,
                    "dur": (s["t1"] - s["t0"]) * 1e6,
                    "args": {**s.get("attrs", {}),
                             "trace_id": r["trace_id"]},
                })
    return events


# ------------------------------------------------------------- commands
def _demo_burst(device=None) -> None:
    """Drive a tiny in-process SortServer burst so scrape/snapshot have
    live serve-tier data in a fresh process."""
    import numpy as np

    from repro_torch.core.planner import SortLimits
    from repro_torch.core.splitters import SortConfig
    from repro_torch.serve.sortd import SortServer

    cfg = SortConfig(use_pallas=False, capacity_factor=2.0)
    rng = np.random.default_rng(7)
    with SortServer(max_batch=8, max_delay_ms=2.0, config=cfg,
                    limits=SortLimits(n_procs=4), device=device) as srv:
        futs = [srv.submit(rng.random(96 + 8 * (i % 3),
                                      ).astype(np.float32))
                for i in range(12)]
        # one direct dispatch so both paths appear in the snapshot
        futs.append(srv.submit(rng.random(128).astype(np.float32),
                               want="order"))
        srv.flush()
        for f in futs:
            f.result()


def cmd_scrape(args) -> int:
    if args.demo:
        _demo_burst(args.device)
    from repro_torch.obs import flight, render_prometheus

    text = render_prometheus()
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        sys.stdout.write(text)
    if args.snapshot:
        with open(args.snapshot, "w") as f:
            json.dump(flight.RECORDER.snapshot(), f, indent=1)
        print(f"wrote {args.snapshot}")
    return 0


def cmd_diff(args) -> int:
    with open(args.prev) as f:
        prev = parse_prom(f.read())
    with open(args.curr) as f:
        curr = parse_prom(f.read())
    lines = diff_metrics(prev, curr)
    print("\n".join(lines) if lines else "no metric changes")
    return 0


def cmd_slow(args) -> int:
    snap = _load_snapshot(args.snapshot)
    reqs = [r for r in snap.get("requests", [])
            if r.get("total_ms") is not None]
    reqs.sort(key=lambda r: r["total_ms"], reverse=True)
    print(f"{'trace_id':>16} {'outcome':>9} {'kind':>9} {'n':>9} "
          f"{'queue_ms':>9} {'exec_ms':>9} {'total_ms':>9}  flush_id")
    for r in reqs[: args.n]:
        def ms(v):
            return f"{v:9.2f}" if v is not None else f"{'-':>9}"
        print(f"{r['trace_id']:>16} {r.get('outcome') or '-':>9} "
              f"{r.get('kind') or '-':>9} {r.get('n') or 0:>9} "
              f"{ms(r.get('queue_wait_ms'))} {ms(r.get('execute_ms'))} "
              f"{ms(r.get('total_ms'))}  {r.get('flush_id') or '-'}")
    return 0


def cmd_export(args) -> int:
    snap = _load_snapshot(args.snapshot)
    events = snapshot_to_chrome(snap, trace_id=args.trace_id)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.out} ({len(events)} events) — open in "
              f"chrome://tracing or https://ui.perfetto.dev")
    else:
        json.dump(doc, sys.stdout, indent=1)
    return 0


def cmd_bench_diff(args) -> int:
    base, fresh = _load_bench(args.base), _load_bench(args.fresh)
    gates = REGRESSION_GATES
    if args.tolerance is not None:
        gates = {op: args.tolerance for op in gates}
    lines, regressions = compare_bench(
        base, fresh, gates=gates,
        tolerance=args.tolerance if args.tolerance is not None else 0.15,
        min_us=args.min_us)
    if args.gates_only:
        lines = [ln for ln in lines if "[info]" not in ln]
    print("\n".join(lines) if lines else "no comparable records")
    if regressions:
        print(f"\n{len(regressions)} regression(s) beyond tolerance:",
              file=sys.stderr)
        for r in regressions:
            print(f"  {r['op']}: {r['base_us']:.1f} -> {r['fresh_us']:.1f} us"
                  f" ({r['ratio']:.2f}x, tolerance {1 + r['tolerance']:.2f}x)",
                  file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obsctl",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("scrape", help="render the Prometheus exposition")
    p.add_argument("--out", default=None, help="write scrape text here")
    p.add_argument("--snapshot", default=None,
                   help="also dump a flight-recorder snapshot JSON here")
    p.add_argument("--demo", action="store_true",
                   help="drive a toy SortServer burst first")
    p.add_argument("--device", default=None,
                   help='the demo server\'s device: "cuda" (default) or "cpu"')
    p.set_defaults(fn=cmd_scrape)

    p = sub.add_parser("diff", help="diff two scrape files")
    p.add_argument("prev")
    p.add_argument("curr")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("slow", help="top-N slow requests from a snapshot")
    p.add_argument("snapshot", help="snapshot file or REPRO_FLIGHT_DIR")
    p.add_argument("-n", type=int, default=10)
    p.set_defaults(fn=cmd_slow)

    p = sub.add_parser("export", help="snapshot -> Chrome/Perfetto trace")
    p.add_argument("snapshot", help="snapshot file or REPRO_FLIGHT_DIR")
    p.add_argument("--out", default=None)
    p.add_argument("--trace-id", default=None,
                   help="export only this request + its flush")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("bench-diff", help="diff two BENCH_<suite>.json")
    p.add_argument("base")
    p.add_argument("fresh")
    p.add_argument("--tolerance", type=float, default=None,
                   help="override every gate's tolerance")
    p.add_argument("--min-us", type=float, default=100.0,
                   help="skip gating records timed under this (noise)")
    p.add_argument("--gates-only", action="store_true",
                   help="hide informational (ungated) rows")
    p.set_defaults(fn=cmd_bench_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
