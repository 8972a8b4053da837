"""A copy of the benchmark with cells of the same configurations and
traffic cut to a size the CPU runs in seconds, for the harness's tests.

The copy lives in a temporary directory: the real files are copied there,
and the tiny configurations, mixes and limits are added beside them under
names of their own, as a later cell would be added.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY_RUN = {
    "qwen2-0.5b": {"family": "dense", "n_layers": 2, "d_model": 64,
                   "n_heads": 4, "n_kv_heads": 2, "d_head": 16, "d_ff": 128,
                   "vocab": 512, "qkv_bias": True, "tie_embeddings": True,
                   "rope_theta": 1000000.0, "norm_eps": 1e-05,
                   "dtype": "bfloat16"},
    "zamba2-7b": {"family": "hybrid", "n_layers": 3, "d_model": 64,
                  "n_heads": 4, "n_kv_heads": 4, "d_head": 16, "d_ff": 128,
                  "vocab": 256, "qkv_bias": False, "tie_embeddings": False,
                  "rope_theta": 10000.0, "norm_eps": 1e-05,
                  "dtype": "bfloat16", "ssm_state": 16, "ssm_head_dim": 16,
                  "ssm_expand": 2, "ssm_conv": 4, "ssm_chunk": 16,
                  "attn_every": 2},
}
TINY_TRAFFIC = {
    "async4-b8x512": {"seq_len": 32, "plan_rounds": 64,
                      "traced_launches": 1},
    "slots16-p512-o64": {"n_slots": 4, "steps_per_launch": 4,
                         "prompt_len": 32, "max_new": 8,
                         "requests_per_serve": 6, "mean_gap_steps": 2.0,
                         "checked_requests": 3, "traced_steps": [4, 12, 16], "calibration_requests": 6},
}


#: the tiny cells' limits, set from their own readings on the CPU (seeds
#: 1-6): training loss_gap program <= 8.9e-5, float8 control >= 2.5e-4;
#: grad_gap program <= 0.0036, control >= 0.019, half batch >= 0.278;
#: change_gap program <= 0.016, a state left unchanged 1; logit_gap
#: zamba2 program <= 0.030, control >= 0.37; qwen2 program <= 0.0041,
#: control >= 0.033
TINY_LIMITS = {
    "train.qwen2-0.5b.async4": {"loss_gap": 1.6e-4, "grad_gap": 0.01,
                                "change_gap": 0.1},
    "serve.zamba2-7b.slots16": {"logit_gap": 0.15},
}


def tiny_copy(dst: str) -> dict:
    """Copy the benchmark to ``dst`` and add a ``tiny.<cell>`` beside each
    cell; → the copy's ``BENCHMARK.json`` object."""
    shutil.copytree(BENCH, os.path.join(dst, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    base = os.path.join(dst, "perfbench")
    for c in list(bench["configs"]):
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["run"] = TINY_RUN[c["name"]]
        name = f"tiny.{c['name']}"
        path = f"perfbench/configs/{name}.json"
        with open(os.path.join(dst, path), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({**c, "name": name, "file": path})
    for w in list(bench["workloads"]):
        with open(os.path.join(base, "traffic", f"{w['traffic']}.json")) as f:
            tr = json.load(f)
        tr.update(TINY_TRAFFIC[w["traffic"]])
        with open(os.path.join(base, "traffic",
                               f"tiny.{w['traffic']}.json"), "w") as f:
            json.dump(tr, f)
        name = f"tiny.{w['name']}"
        with open(os.path.join(base, "limits", f"{name}.json"), "w") as f:
            json.dump({"numbers": {k: {"limit": v} for k, v in
                                   TINY_LIMITS[w["name"]].items()}}, f)
        bench["workloads"].append({**w, "name": name,
                                   "config": f"tiny.{w['config']}",
                                   "traffic": f"tiny.{w['traffic']}"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench


def run_tiny(dst: str, cell: str, seed: int = 12345, trace: bool = False,
             seconds: float = 0.5, device: str = "cpu",
             prefix: str = "tiny.") -> dict:
    """One run of ``<prefix><cell>`` in a copy made by :func:`tiny_copy`
    (the harness's look for a card skipped)."""
    import time

    from perfbench import harness

    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return harness.run_cell(bench, f"{prefix}{cell}", seed, seconds, trace,
                            device, time.time(),
                            base=os.path.join(dst, "perfbench"), root=dst)
