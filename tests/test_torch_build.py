"""The kernel build's cache key (``repro_torch/kernels/_build.py``).

A library is reused when its name matches, so the name must change with
everything that goes into it: the ``.cu`` source, every shared header of
``csrc/`` it may include, and the flags (an ``-I`` among them).  Nothing
here compiles: ``library_path`` only names the library.
"""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build                      # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", ["flash_attention", "ssd_chunk",
                                  "async_update"])
def test_build_key_follows_source_headers_and_flags(csrc, monkeypatch, name):
    first = _build.library_path(name)
    assert first == _build.library_path(name)          # stable
    assert first.parent == _build.BUILD_DIR and first.name.startswith(name)

    header = csrc / "mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build.library_path(name)
    assert edited != first

    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = _build.library_path(name)
    assert added != edited

    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.library_path(name) != added

    flags = _build.NVCC_FLAGS + ("-I", str(csrc))
    before = _build.library_path(name)
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags)
    assert _build.library_path(name) != before


def test_csrc_holds_the_shared_header():
    """Both redesigned kernels include ``mma.cuh``."""
    assert (_build.CSRC / "mma.cuh").is_file()
    for name in ("flash_attention", "ssd_chunk"):
        assert '#include "mma.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
