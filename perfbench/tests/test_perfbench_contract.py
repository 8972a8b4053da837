"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files found by name."""
from __future__ import annotations

import json
import os
import re

import pytest

from perfbench_tiny import BENCH, ROOT

from perfbench import judge, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert bench["command"][:2] == ["python3", "perfbench/run.py"]
    assert len(bench["command"]) <= 32 and all(_line(w)
                                               for w in bench["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["config"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in bench[kind]]
        assert len(got) == len(set(got)), kind
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in bench["workloads"]:
        assert _line(w["why"])
    for c in bench["configs"]:
        assert _line(c["why"]) and _line(c["source"])
    for m in bench["per_layer"]:
        assert _line(m["layer"])


def test_entries_have_just_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_the_contract_asks(bench):
    e2e_names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e_names
    for w in bench["workloads"]:
        e2e, layer = registry.cell_metrics(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_run_seconds_fits_the_check_with_24_cells(bench):
    rs = bench["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_each_cell_files_resolve_by_name(bench):
    for w in bench["workloads"]:
        cfg = registry.config(bench, w["config"])
        assert cfg["run"]["family"] == cfg["family"]
        traffic = registry.traffic(w["traffic"])
        assert callable(registry.lane(traffic["lane"]).run)
        e2e, layer = registry.cell_metrics(bench, w["name"])
        for m in e2e + layer:
            assert callable(registry.metric(m["name"]).read)
        lims = judge.limits(w["name"])
        assert lims and all(v > 0 for v in lims.values())


def test_configuration_sizes_are_the_programs(bench):
    """The ``run`` sizes the benchmark draws weights for, and its
    reference computes with, are the program's registry config in every
    width; any other key (the release's norm epsilon) is one the program
    takes as an override, as the lanes hand it over."""
    from repro_torch.configs import get_arch

    for c in bench["configs"]:
        cfg = registry.config(bench, c["name"])
        arch = get_arch(cfg["registry"])
        run = arch.with_(**cfg["run"])
        for k, v in cfg["run"].items():
            assert getattr(run, k) == v, (c["name"], k)
            if k not in ("norm_eps",):
                assert getattr(arch, k) == v, (c["name"], k)
        assert cfg["reduced"] == c["reduced"] == []


def test_limits_lie_between_their_readings():
    for name in os.listdir(os.path.join(BENCH, "limits")):
        with open(os.path.join(BENCH, "limits", name)) as f:
            numbers = json.load(f)["numbers"]
        for k, v in numbers.items():
            assert v["lower"] < v["limit"] < v["upper"], (name, k)
            assert v["upper"] >= 3 * v["lower"], (name, k)
