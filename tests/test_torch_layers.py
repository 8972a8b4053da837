"""`repro_torch.models.layers` against `repro.models.layers` on shared inputs.

f32 at rtol = atol = 1e-5 (sums taken in another order); bf16 at 3e-2, the
kernel suite's bf16 tolerance (the two frameworks round bf16 products at
other places)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as JL                    # noqa: E402
from repro_torch.models import layers as TL              # noqa: E402
from torch_parity import TOL, f32, pair, randn           # noqa: E402

DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = pair(randn(rng, 2, 5, 32) * 3.0, dtype)
    wj, wt = pair(randn(rng, 32), dtype)
    np.testing.assert_allclose(f32(TL.rms_norm(xt, wt, 1e-5)),
                               f32(JL.rms_norm(xj, wj, 1e-5)), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [0, 37])
def test_rope(dtype, offset):
    rng = np.random.default_rng(1)
    xj, xt = pair(randn(rng, 2, 7, 4, 32), dtype)
    pos = np.arange(offset, offset + 7, dtype=np.int32)
    got = TL.rope(xt, torch.from_numpy(pos), 1e6)
    want = JL.rope(xj, pos, 1e6)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


def _qkv(rng, B, Sq, Sk, H, KV, D, dtype):
    return (pair(randn(rng, B, Sq, H, D), dtype),
            pair(randn(rng, B, Sk, KV, D), dtype),
            pair(randn(rng, B, Sk, KV, D), dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None)])
def test_attention_dense(dtype, causal, window):
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, 24, 24, 4, 2, 32, dtype)
    got = TL.attention(qt, kt, vt, causal=causal, window=window)
    want = JL.attention(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 12])
def test_attention_chunked(dtype, window):
    """Sq = 40 > dense_max with chunk_q = 16: two chunks and a tail of 8."""
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, 40, 40, 4, 1, 32, dtype)
    kw = dict(causal=True, window=window, chunk_q=16, dense_max=16)
    got = TL.attention(qt, kt, vt, **kw)
    want = JL.attention(qj, kj, vj, **kw)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention(dtype, window):
    rng = np.random.default_rng(4)
    W, pos = 16, 10
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, 1, W, 4, 2, 32, dtype)
    cpos = np.full((W,), -1, np.int32)
    cpos[:pos + 1] = np.arange(pos + 1)
    cpos[13] = 99                                    # a stale future slot
    got = TL.decode_attention(qt, kt, vt, torch.from_numpy(cpos), pos,
                              window=window)
    want = JL.decode_attention(qj, kj, vj, cpos, np.int32(pos), window=window)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu(dtype):
    rng = np.random.default_rng(5)
    xj, xt = pair(randn(rng, 2, 5, 32), dtype)
    gj, gt = pair(randn(rng, 32, 48) * 0.2, dtype)
    uj, ut = pair(randn(rng, 32, 48) * 0.2, dtype)
    dj, dt = pair(randn(rng, 48, 32) * 0.2, dtype)
    np.testing.assert_allclose(f32(TL.swiglu(xt, gt, ut, dt)),
                               f32(JL.swiglu(xj, gj, uj, dj)), **TOL[dtype])
