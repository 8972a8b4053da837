"""Find a cell's files by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
traffic file names its lane; each metric is a reader of its own.  So the
files are found by name alone, and a later cell, mix, lane or metric is a
new file and a new entry, with no edit to a file that is there:

* ``perfbench/configs/<config>.json`` (the path ``BENCHMARK.json`` gives);
* ``perfbench/traffic/<traffic>.json``;
* ``perfbench/lanes/<lane>.py``, the module ``perfbench.lanes.<lane>``
  with ``run(ctx) -> record``;
* ``perfbench/metrics/<metric>.py``, a module with ``read(record)``,
  loaded from its file (a metric's name may hold dots).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; the cells are "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, base: str = HERE) -> dict:
    with open(os.path.join(base, "traffic", f"{name}.json")) as f:
        return json.load(f)


def lane(name: str):
    return importlib.import_module(f"perfbench.lanes.{name}")


def metric(name: str, base: str = HERE):
    """The reader ``metrics/<name>.py`` under ``base``, loaded from its
    file (a metric's name may hold dots)."""
    path = os.path.join(base, "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_cell(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def cell_metrics(bench: dict, cell_name: str) -> tuple:
    """(end-to-end entries, per-layer entries) the cell reports.  A
    per-layer metric without ``workloads`` is reported wherever the
    end-to-end metric it moves is."""
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, cell_name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell_name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer
