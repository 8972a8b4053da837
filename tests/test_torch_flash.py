"""The port's flash attention against the Pallas kernel (interpret mode).

The case matrix is that of ``test_kernels.py`` (MHA, GQA 4:1, ragged MQA,
D = 128, windows 16/64/1000, non-causal) with sequences cut to ≤ 128, at its
tolerances: f32 2e-4, bf16 3e-2.  On the CPU the port runs the kernel's
plain version; the CUDA kernel itself is held to it on the card by the
``cuda``-marked tests of ``test_torch_cuda.py``.

The kernel's bf16 route rounds in one place the plain version does not:
P, the probabilities of a 64-key tile under the running max, goes into
P·V as bf16 (l sums them in f32), and 1/√D scales the f32 scores.
:func:`tensor_core_model` writes those rounding points in plain torch, tile
by tile, and is held to the Pallas kernel at the main path's widths before
any card sees the kernel.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as FA             # noqa: E402
from repro_torch.kernels import ops                               # noqa: E402
from repro_torch.kernels.ref import attention_mask                # noqa: E402
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


def tensor_core_model(q, k, v, *, causal=True, window=None, tile=64):
    """The bf16 route of ``csrc/flash_attention.cu`` in plain torch: f32
    scores of the bf16 inputs, masks as -inf, the online softmax over
    64-key tiles in base 2 with the scale on the f32 scores, P rounded to
    bf16 before P·V, l summed from the f32 P, an empty row 0."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // KV, dim=2)
    vf = v.float().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf)
    s = s.masked_fill(~attention_mask(Sq, Sk, causal, window), -math.inf)
    sl = math.log2(math.e) / math.sqrt(D)
    m = torch.full((B, H, Sq), -math.inf)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, D))
    for k0 in range(0, Sk, tile):
        st = s[..., k0:k0 + tile]
        mx = torch.maximum(m, st.amax(-1))
        off = torch.where(mx == -math.inf, 0.0, mx * sl)
        alpha = torch.exp2(m * sl - off)
        p = torch.exp2(st * sl - off[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, k0:k0 + tile])
        m = mx
    out = torch.where(l[..., None] == 0, 0.0, acc / l[..., None])
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", [
    (1, 192, 192, 14, 2, True, None),     # H/KV = 7, three tiles
    (1, 200, 200, 7, 1, True, 100),       # ragged S, a window off the tile
    (1, 128, 200, 14, 2, False, None),    # non-causal, Sk > Sq
])
def test_flash_tensor_core_rounding_matches_pallas(B, Sq, Sk, H, KV, causal,
                                                   window):
    """The bf16 route's rounding points, at the main path's D = 64 and
    H/KV = 7, against the Pallas kernel in interpret mode at the bf16
    tolerance."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(B, Sq, Sk, H, KV, 64, "bfloat16")
    want = flash_attention_pallas(qj, kj, vj, causal=causal, window=window,
                                  block_q=64, block_k=64, interpret=True)
    got = tensor_core_model(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **TOL["bfloat16"])
    # the same model holds the plain version the kernel is gated against
    np.testing.assert_allclose(
        f32(got), f32(FA.flash_attention_plain(qt, kt, vt, causal=causal,
                                               window=window)),
        **TOL["bfloat16"])


def test_flash_kernel_route_follows_dtype():
    """bf16 takes the tensor-core route, f32 keeps the CUDA-core kernel
    (its tolerance of 2e-4 rules out bf16 or TF32 operands); nothing else
    has a route."""
    assert FA.route(torch.bfloat16) == "tensor_cores"
    assert FA.route(torch.float32) == "cuda_cores"
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.route(torch.float16)


def _attention_configs():
    from repro_torch.configs import ARCHS
    for name, cfg in sorted(ARCHS.items()):
        if cfg.family != "ssm":              # the ssm family has no attention
            yield f"{name}-full", cfg
            yield f"{name}-reduced", cfg.reduced()


@pytest.mark.parametrize("label,cfg", list(_attention_configs()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_every_config_head_dim_is_built(label, cfg):
    """The CUDA kernel is built for every head dim a config reaches (full
    width and reduced): zamba2-7b's 112 as much as qwen2-0.5b's 64."""
    assert cfg.d_head in FA.HEAD_DIMS, (label, cfg.d_head)


def test_head_dims_are_the_multiples_of_16_up_to_128():
    assert FA.HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
