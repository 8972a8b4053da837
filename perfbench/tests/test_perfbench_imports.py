"""No module under ``perfbench/`` imports JAX or the JAX package, and the
reference imports nothing of the program: every import's top-level name,
the part before the first dot, is compared whole (``repro_torch`` begins
with ``repro`` and is not ``repro``)."""
from __future__ import annotations

import ast
import os

import pytest

from perfbench_tiny import BENCH

from perfbench import harness

NEVER = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _modules(under: str) -> list:
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(under)
                  for f in fs if f.endswith(".py"))


def test_the_walk_finds_every_module():
    names = {os.path.relpath(p, BENCH) for p in _modules(BENCH)}
    assert {"run.py", "harness.py", "lanes/train.py", "lanes/slots.py",
            "reference/dense.py", "reference/hybrid.py",
            "metrics/idle_share.train.py"} <= names


@pytest.mark.parametrize("path", _modules(BENCH),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize(
    "path", _modules(os.path.join(BENCH, "reference")),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_whole_names_are_compared(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.models\nfrom reproduce import x\n"
                 "import jaxlib.xla_client\n")
    assert top_level_imports(str(p)) == {"repro_torch", "reproduce",
                                         "jaxlib"}


def test_the_run_names_a_loaded_jax_package(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_probe",
                        types.ModuleType("repro_torch_probe"))
    assert "repro" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro" in harness.loaded_forbidden()
