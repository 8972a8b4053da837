"""Read the numbers that ``correct`` compares, on many seeds in one
process, for the program, the control and the planted faults; the limits
in ``perfbench/limits/<cell>.json`` are set from these readings.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--out FILE.jsonl]

Run on the card, at the cell's own size; the benchmark's runs never call
it.  For each seed it prints one JSON line:

* training: ``program`` — the program's first rounds against the
  reference's; ``control`` — the reference run with every product's
  operands in float8 e4m3, put in the program's place; ``drop_half`` —
  the reference with half of the participating rows left out and the
  mean taken over the rest (a planted fault).  A state left unchanged
  reads 1 on ``change_gap`` by its definition and needs no run.
* serving: ``program`` — the widest logit gap of the served tokens of a
  sample of one serve of ``calibration_requests`` at the cell's own
  load; ``control`` — the widest
  gap of the tokens the float8 reference puts first at the same
  positions.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_readings(ctx, seed: int) -> dict:
    from perfbench import judge
    from perfbench.lanes.train import Session
    from perfbench.reference.common import FP8Arith

    n = ctx.traffic["checked_rounds"]
    s = Session(ctx, seed)
    prog = s.first_rounds(n)
    s.free()
    ref = s.reference(n)
    ctl = s.reference(n, FP8Arith())
    leaves = {k: {"grad0": [ref["grad0"][k], prog["grad0"][k],
                            ctl["grad0"][k]],
                  "change": [ref["change"][k], prog["change"][k],
                             ctl["change"][k]]} for k in ref["grad0"]}
    return {"program": judge.train_numbers(prog, ref),
            "control": judge.train_numbers(ctl, ref),
            "drop_half": judge.train_numbers(
                s.reference(n, drop_half=True), ref),
            "leaves": leaves}


def serve_readings(ctx, seed: int) -> dict:
    import numpy as np
    import torch

    from perfbench.lanes import slots
    from perfbench.reference.common import FP8Arith

    t = ctx.traffic
    s = slots.Session(ctx, seed)
    s.serve(t["warm_requests"], slots.WARM)
    serves = [s.serve(t["calibration_requests"], 0)]
    s.free()
    picks = slots.sample(np.random.default_rng([seed, 7]), serves,
                         t["checked_requests"])
    seqs, toks = slots.sequences(serves, picks)
    ref = s.reference_logits(seqs)
    ctl = s.reference_logits(seqs, FP8Arith())
    top = torch.argmax(ctl, dim=-1).cpu().numpy()
    return {"program": {"logit_gap": slots.gap(ref, toks, ctx.device)},
            "control": {"logit_gap": slots.gap(ref, top, ctx.device)}}


def readings(ctx, seed: int) -> dict:
    lane = ctx.traffic["lane"]
    return {"train": train_readings, "slots": serve_readings}[lane](ctx, seed)


def main(argv=None) -> int:
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from perfbench import registry
    from perfbench.harness import Context

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate.py reads the numbers on a CUDA card", file=sys.stderr)
        return 2
    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    ctx = Context(cell, registry.config(bench, cell["config"]),
                  registry.traffic(cell["traffic"]), 0, 0.0, False,
                  torch.device("cuda"), time.time())
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.time()
        row = {"cell": args.workload, "seed": seed, **readings(ctx, seed),
               "seconds": time.time() - t0,
               "device": torch.cuda.get_device_name()}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
