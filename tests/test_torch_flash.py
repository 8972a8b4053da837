"""The port's flash attention against the Pallas kernel (interpret mode).

The case matrix is that of ``test_kernels.py`` (MHA, GQA 4:1, ragged MQA,
D = 128, windows 16/64/1000, non-causal) with sequences cut to ≤ 128, at its
tolerances: f32 2e-4, bf16 3e-2.  On the CPU the port runs the kernel's
plain version; the CUDA kernel itself is held to it on the card by the
``cuda``-marked tests of ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as FA             # noqa: E402
from repro_torch.kernels import ops                               # noqa: E402
from torch_parity import f32, pair, randn                         # noqa: E402

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _inputs(B, Sq, Sk, H, KV, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (pair(randn(rng, B, Sq, H, D), dtype),
            pair(randn(rng, B, Sk, KV, D), dtype),
            pair(randn(rng, B, Sk, KV, D), dtype))


def _check(B, Sq, Sk, H, KV, D, bq, bk, dtype, causal, window):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(B, Sq, Sk, H, KV, D, dtype)
    want = flash_attention_pallas(qj, kj, vj, causal=causal, window=window,
                                  block_q=bq, block_k=bk, interpret=True)
    got = FA.flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,bq,bk", [
    (1, 128, 128, 4, 4, 64, 64, 64),      # MHA square
    (2, 128, 128, 8, 2, 64, 64, 32),      # GQA 4:1
    (1, 96, 120, 4, 1, 32, 64, 64),       # ragged (padding path), MQA
    (1, 128, 128, 2, 2, 128, 64, 64),     # D = 128
])
def test_flash_plain_causal(dtype, B, Sq, Sk, H, KV, D, bq, bk):
    _check(B, Sq, Sk, H, KV, D, bq, bk, dtype, True, None)


@pytest.mark.parametrize("window", [16, 64, 1000])
def test_flash_plain_sliding_window(window):
    _check(1, 128, 128, 4, 4, 64, 64, 64, "float32", True, window)


def test_flash_plain_noncausal():
    _check(2, 64, 128, 4, 4, 64, 64, 64, "float32", False, None)


def test_flash_plain_empty_rows_are_zero():
    """Sq > Sk, non-causal window: query rows ≥ Sk + window − 1 see no key.
    The kernel writes 0 there (the JAX oracle would average v)."""
    got = _check(1, 128, 32, 2, 2, 32, 32, 32, "float32", False, 16)
    empty = np.arange(128) >= 32 + 16 - 1
    assert np.all(f32(got)[:, empty] == 0.0)
    assert np.all(np.abs(f32(got)[:, ~empty]).sum(axis=(0, 2, 3)) > 0)


def test_ops_cpu_tensor_takes_plain_version():
    (_, qt), (_, kt), (_, vt) = _inputs(1, 40, 40, 4, 2, 32, "float32")
    before = FA.launches
    got = ops.flash_attention(qt, kt, vt, causal=True, window=8)
    want = FA.flash_attention_plain(qt, kt, vt, causal=True, window=8)
    assert FA.launches == before
    assert torch.equal(got, want)


def test_kernel_wrapper_rejects_cpu_tensors():
    (_, qt), (_, kt), (_, vt) = _inputs(1, 8, 8, 2, 2, 32, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_cuda(qt, kt, vt)
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.flash_attention(qt.to("meta"), kt.to("meta"), vt.to("meta"))


def test_cuda_request_without_cuda_raises(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.api import ExperimentSpec, ServeJob, run
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(get_arch("qwen2-0.5b").reduced(), 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(ExperimentSpec(objective=ServeJob(), T=2))
    assert resolve_device("cpu").type == "cpu"
