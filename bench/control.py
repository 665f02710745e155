#!/usr/bin/env python3
"""The readings that set a cell's limits: the program's and the control's.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 [--program-seeds 4,5,...]

The control is the plain reference put in the program's place at the
precision below the one the configuration states (``reference/sort.py``'s
``control``: float32 keys as bfloat16, or an unstable argsort where the
keys' precision cannot drop; ``reference/moe_lm.py``'s ``fp8_rounding``
for a bfloat16 model). It runs at the cell's own size, on the card, and
prints one JSON line a seed with the numbers the run compares. For a
model the program's own readings come from the same process: for each of
``--program-seeds`` the model is built with that seed's weights and the
timed path (``serve.engine.make_prefill``) serves the check's sample of
prompts. A sort's program readings are the benchmark's runs themselves.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

from benchlib import compare, registry, traffic  # noqa: E402


def _sort(cell, config, tr, wl, seed, device):
    import torch

    from reference import sort as ref

    n = config["keys_per_card"]
    x = torch.cat([traffic.sort_input(tr, n, seed, 0, r, device) for r in range(tr["ranks"])])
    want_keys, want_order = ref.sort(x, tr["want"])
    keys, order = ref.control(x, tr["want"])
    out = {"keys_mismatched": ref.mismatches(keys, want_keys)}
    if tr["want"] == "order":
        out["order_mismatched"] = ref.mismatches(order, want_order)
    return out


def _lm_readings(config, tr, wl, seed, device, program: bool):
    import torch

    from benchlib.drivers import lm

    ref = registry.reference(config["reference"])
    V = config["vocab"]
    prompts = traffic.prompts(tr, V, seed, device)[:wl["check"]["sample"]]  # (R, B, S)
    if program:
        from repro_torch.serve import engine

        model = lm.build_model(config, seed, device)
        prefill = engine.make_prefill(model)
        got = []
        for p in prompts:
            logits, _ = prefill({"tokens": p})
            got += [(logits[b, -1, :V], logits[b, -1, :V].argmax()) for b in range(p.shape[0])]
        del model, prefill
        torch.cuda.empty_cache()
    want = ref.last_logits(config, seed, prompts, device).flatten(0, 1)
    if not program:
        low = ref.last_logits(config, seed, prompts, device,
                              rounding=ref.fp8_rounding).flatten(0, 1)
        got = [(low[j], low[j].argmax()) for j in range(low.shape[0])]
    err = gap = 0.0
    for j, (g, served) in enumerate(got):
        e, t = compare.logits(want[j], g, served)
        err, gap = max(err, e), max(gap, t)
    return {"logit_err": err, "token_gap": gap}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="the control's seeds, comma-separated")
    p.add_argument("--program-seeds", default="", help="the program's seeds (a model's cell)")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("refused: the control runs at the cell's size on a card", file=sys.stderr)
        return 2
    spec = registry.benchmark()
    cell = registry.cell(spec, a.workload)
    config, tr = registry.config(cell["config"]), registry.traffic(cell["traffic"])
    wl = registry.workload(a.workload)
    device = torch.device("cuda", 0)
    print(json.dumps({"device": torch.cuda.get_device_name(device)}), flush=True)
    for side, seeds in (("program", a.program_seeds), ("control", a.seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            if config["kind"] == "sort":
                if side == "program":
                    continue
                reading = _sort(a.workload, config, tr, wl, seed, device)
            else:
                reading = _lm_readings(config, tr, wl, seed, device, side == "program")
            print(json.dumps({"seed": seed, side: reading}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
