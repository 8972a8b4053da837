"""A later cell, traffic mix and per-layer metric are new files and new
entries: the harness finds them by name with no edit to a file that is
there."""
from __future__ import annotations

import hashlib
import json
import os

from perfbench_tiny import run_tiny, tiny_copy

from perfbench import registry


def _digests(base: str) -> dict:
    out = {}
    for d, _, fs in os.walk(base):
        for f in fs:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, base)] = \
                        hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_fixture_cell_metric_and_traffic_are_found(tmp_path):
    dst = str(tmp_path)
    tiny_copy(dst)
    base = os.path.join(dst, "perfbench")
    before = _digests(base)
    # the new traffic: a longer tiny mix of the same lane
    with open(os.path.join(base, "traffic",
                           "tiny.slots16-p512-o64.json")) as f:
        mix = json.load(f)
    mix["requests_per_serve"] = 9
    with open(os.path.join(base, "traffic", "fixture-mix.json"), "w") as f:
        json.dump(mix, f)
    # the new per-layer metric: a reader of its own
    with open(os.path.join(base, "metrics", "fixture_requests.py"),
              "w") as f:
        f.write("def read(rec):\n"
                "    return sum(s['requests'] for s in rec['serves'])\n")
    # its limit: the tiny dense serve's, read on the CPU (perfbench_tiny)
    with open(os.path.join(base, "limits", "fixture.cell.json"), "w") as f:
        json.dump({"numbers": {"logit_gap": {"limit": 0.02}}}, f)
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "fixture.cell",
                               "config": "tiny.qwen2-0.5b",
                               "traffic": "fixture-mix", "chips": 1,
                               "why": "a fixture"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_tokens_per_s":
            m["workloads"].append("fixture.cell")
    bench["per_layer"].append({"name": "fixture_requests", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "slot server",
                               "moves": "serve_tokens_per_s",
                               "workloads": ["fixture.cell"]})
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    changed = {k for k, v in _digests(base).items() if before.get(k) != v}
    assert changed == {"traffic/fixture-mix.json",
                       "metrics/fixture_requests.py",
                       "limits/fixture.cell.json"}
    _, layer = registry.cell_metrics(bench, "fixture.cell")
    assert [m["name"] for m in layer][-1] == "fixture_requests"
    out = run_tiny(dst, "cell", trace=True, prefix="fixture.")
    assert out["correct"]
    assert out["metrics"]["fixture_requests"]["value"] % 9 == 0
