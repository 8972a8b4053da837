"""Runs of the tiny cells on the CPU (the harness's look for a card
skipped): sound runs come out correct; the control put in the program's
place, and each fault a cell can have planted underneath the timed path,
come out not correct.  A run without a card, or without the program
beside the benchmark, prints no result."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench_tiny import BENCH, ROOT, TINY_LIMITS, run_tiny, tiny_copy

CELLS = ["train.qwen2-0.5b.async4", "serve.zamba2-7b.slots16"]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("bench"))
    tiny_copy(dst)
    return dst


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(copy, cell):
    out = run_tiny(copy, cell, seed=2**31 + 11)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == set(TINY_LIMITS[cell])
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]


def test_a_traced_run_reports_per_layer_metrics(copy):
    out = run_tiny(copy, "serve.zamba2-7b.slots16", trace=True)
    assert out["correct"]
    assert "serve_mfu" in out["metrics"] and "setup_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_training_control_is_not_correct(copy, monkeypatch):
    """The float8 reference in the program's place."""
    from perfbench.lanes import train
    from perfbench.reference.common import FP8Arith

    def control(self, n):
        return self.reference(n, FP8Arith())

    monkeypatch.setattr(train.Session, "first_rounds", control)
    out = run_tiny(copy, "train.qwen2-0.5b.async4", seed=2**31 + 12)
    assert not out["correct"]


@pytest.mark.parametrize("cell", CELLS[1:])
def test_the_serving_control_is_not_correct(copy, cell):
    """The tokens the float8 reference puts first, judged as the
    program's are."""
    from perfbench import calibrate, judge, registry
    from perfbench.harness import Context

    with open(os.path.join(copy, "BENCHMARK.json")) as f:
        bench = json.load(f)
    base = os.path.join(copy, "perfbench")
    c = registry.cell(bench, f"tiny.{cell}")
    ctx = Context(c, registry.config(bench, c["config"], copy),
                  registry.traffic(c["traffic"], base), 0, 0.0, False,
                  torch.device("cpu"), time.time(), base)
    for seed in (1, 2, 3):
        got = calibrate.serve_readings(ctx, seed)
        lims = judge.limits(c["name"], base)
        assert judge.passed(judge.checks(got["program"], lims))
        assert not judge.passed(judge.checks(got["control"], lims))


def test_a_step_that_returns_its_state_unchanged(copy, monkeypatch):
    from repro_torch.distributed import AsyncTrainer
    from repro_torch.tree import tree_map

    make = AsyncTrainer.train_step_fn

    def frozen(self):
        step = make(self)

        def run(state, *a, **k):
            _, metrics = step(tree_map(torch.clone, state), *a, **k)
            return state, metrics
        return run

    monkeypatch.setattr(AsyncTrainer, "train_step_fn", frozen)
    out = run_tiny(copy, "train.qwen2-0.5b.async4")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(copy, monkeypatch):
    from repro_torch.distributed import AsyncTrainer

    weights = AsyncTrainer._example_weights

    def half(self, mask, batch_size):
        w = weights(self, mask, batch_size).clone()
        w[1::2] = 0                   # the mean taken over the rest
        return w

    monkeypatch.setattr(AsyncTrainer, "_example_weights", half)
    out = run_tiny(copy, "train.qwen2-0.5b.async4")
    assert not out["correct"]


@pytest.mark.parametrize("cell", CELLS[1:])
def test_a_token_altered_where_it_is_produced(copy, monkeypatch, cell):
    from repro_torch.distributed import slot_serve

    step = slot_serve._Lanes.step

    def altered(self, params, j):
        step(self, params, j)
        tap = self.tap[j]
        tap[0] = torch.where(tap[1] != 0, (tap[0] + 1) % self.cfg.vocab,
                             tap[0])

    monkeypatch.setattr(slot_serve._Lanes, "step", altered)
    out = run_tiny(copy, cell)
    assert not out["correct"]


def _run_py(cwd, env_path=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run_py(ROOT)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """BENCHMARK.json and perfbench/ without the program beside them."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from perfbench import harness, registry; "
            "harness.run_cell(registry.load_benchmark('.'), "
            f"'{CELLS[0]}', 1, 1.0, False, 'cpu', time.time(), root='.')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "repro_torch" in p.stderr


@pytest.mark.cuda
def test_the_tiny_cells_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tiny_copy(str(tmp_path))
    for cell in CELLS:
        out = run_tiny(str(tmp_path), cell, device="cuda")
        assert out["correct"], (cell, out["checks"])
        assert out["device"]["platform"] == "gpu"
