"""Hill-climbing harness: hypothesis → change → re-trace → measure.

Counterpart of ``repro/launch/hillclimb.py``.  Each experiment is a named
Rules or config variant applied to one (arch × shape); the harness traces
each on ``meta`` (``dryrun.run_one``), derives the roofline terms from the
op count with H100 constants, and prints them side by side.

The traced step is rank 0 of the production mesh ``32x8`` (data 32 ×
model 8), as the JAX hill-climb lowers its step on the
production mesh: a Rules variant moves the traced terms there
(``seq_parallel`` splits the residual on ``seq`` over the model axis, so
the rank's attention covers its block of the queries), as a config
variant (``update_impl``, ``microbatches``) does.  (On one card's step,
with no model axis, a Rules variant would move only the analytic sharded
state, ``sharded_state_bytes``.)

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair grok_train

writes ``experiments/hillclimb_torch_{pair}.json`` (the JAX hill-climb
keeps ``experiments/hillclimb_{pair}.json``).
"""
from __future__ import annotations

import argparse
import json
import os

from ..distributed.sharding import Rules, SEQ_PARALLEL_RULES
from .dryrun import run_one
from .roofline import terms as roofline_terms

#: the production mesh whose rank 0 is traced
MESH = "32x8"


def terms(rec):
    oc = rec["op_cost"]
    t = roofline_terms(oc)
    return {
        "compute_s": t["compute"],
        "memory_s": t["memory"],
        "collective_s": t["collective"],
        "mem_gb": rec["memory"]["peak_bytes_est"] / 1e9,
        "coll_breakdown": {k: round(v / 1e9, 2)
                           for k, v in oc["collective_breakdown"].items()},
        "sharded_state_gb": {k: round(v / 1e9, 3)
                             for k, v in rec["sharded_state_bytes"].items()},
    }


def compare(arch, shape, variants, out=None):
    """variants: list of (name, rules_or_None, extra_kwargs of run_one),
    each traced on rank 0 of :data:`MESH`."""
    results = {}
    for name, rules, kw in variants:
        rec = run_one(arch, shape, rules=rules or Rules(), verbose=False,
                      mesh=MESH, **kw)
        results[name] = {"ok": rec["ok"],
                         **(terms(rec) if rec["ok"] else
                            {"error": rec.get("error")})}
        t = results[name]
        if rec["ok"]:
            print(f"  {name:28s} comp={t['compute_s']:.3f}s "
                  f"mem={t['memory_s']:.3f}s coll={t['collective_s']:.3f}s "
                  f"peak={t['mem_gb']:.1f}GB state/dev="
                  f"{t['sharded_state_gb']}", flush=True)
        else:
            print(f"  {name:28s} FAIL {t['error'][:120]}", flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    return results


PAIRS = {
    # most representative of the paper's technique + biggest model
    "grok_train": ("grok-1-314b", "train_4k"),
    # most collective-bound (expert-parallel MoE)
    "deepseek_train": ("deepseek-moe-16b", "train_4k"),
    # worst useful-compute ratio (14 unshardable heads)
    "qwen2_prefill": ("qwen2-0.5b", "prefill_32k"),
}

#: named variants for ``--variants``: (rules or None, run_one kwargs): a
#: Rules variant and a config variant
VARIANTS = {
    "baseline": (None, {}),
    "seq_parallel": (SEQ_PARALLEL_RULES, {}),
    "pooled": (None, {"update_impl": "pallas_pooled"}),
}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.hillclimb")
    ap.add_argument("--pair", choices=list(PAIRS), required=True)
    ap.add_argument("--variants", default="baseline",
                    help="comma-separated names of " + ", ".join(VARIANTS))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    bad = [n for n in names if n not in VARIANTS]
    if bad:
        ap.error(f"unknown variants {bad}; choose from {list(VARIANTS)}")
    arch, shape = PAIRS[args.pair]
    print(f"== {arch} × {shape} on rank 0 of {MESH}")
    os.makedirs("experiments", exist_ok=True)
    compare(arch, shape, [(n, *VARIANTS[n]) for n in names],
            out=f"experiments/hillclimb_torch_{args.pair}.json")


if __name__ == "__main__":
    main()
