"""The SSD pieces of `repro_torch` against the JAX package.

* The SSD chunk kernel's plain version (``ops.ssd_chunk`` on the CPU: what
  the CUDA kernel is held to on the card) against the Pallas kernel in
  interpret mode and against the sequential recurrence oracle, over the
  case matrix of ``tests/test_kernels.py:167-168`` in f32 and bf16.
* The port's ``ssd_chunked`` against the JAX ``ssd_chunked``, each branch
  with its own twin (``use_kernel`` False with False, True with True): with
  the kernel the intra-chunk y lands in x's dtype before the inter-chunk
  term is added, so pairing across the branches holds only to bf16
  tolerance (``test_kernels.py:255-267``).
* The one-token SSD step, the depthwise causal conv and its decode step.
* The rounding points of the kernel's bf16 route (:func:`tensor_core_model`):
  dt folded into the f32 score and decay factors, which alone are rounded to
  bf16, as hi + lo (the kernel's default) or once, while x enters exact;
  held to the Pallas kernel at the serving path's widths before any card
  sees the kernel.

Inputs are drawn with numpy and handed to both.  Tolerances: against the
sequential oracle those of ``test_kernels.py`` (f32 1e-3, bf16 4e-2: the
chunked and the sequential sums differ in order and in where bf16 rounds);
between the two packages the arithmetic is the same up to summation order,
so f32 1e-5 and, for an output cast to bf16, one bf16 ulp (rtol 2⁻⁷); a
bf16 input path that rounds the same products in other places (the conv's
bf16 sums, which XLA may keep in f32) 3e-2, the model suite's bf16
tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                        # noqa: E402

from repro.kernels import ref as jref                          # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk_pallas           # noqa: E402
from repro.models import layers as JL                          # noqa: E402
from repro_torch.kernels import ops                            # noqa: E402
from repro_torch.kernels import ref as tref                    # noqa: E402
from repro_torch.kernels import ssd_chunk as SSD               # noqa: E402
from repro_torch.models import layers as TL                    # noqa: E402
from torch_parity import f32, pair                             # noqa: E402

DTYPES = ["float32", "bfloat16"]
ORACLE_TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
              "bfloat16": dict(rtol=4e-2, atol=4e-2)}
SAME = dict(rtol=1e-5, atol=1e-5)
ULP = {"float32": SAME, "bfloat16": dict(rtol=2 ** -7, atol=1e-5)}
BF16 = dict(rtol=3e-2, atol=3e-2)


def _chunk_inputs(c, H, P, N, dtype, seed=3, lead=()):
    """x · 0.5 in ``dtype``, dt ∈ [0.01, 0.2], A ∈ −[0.5, 2], B/C · 0.3 in
    f32, as ``test_kernels.py`` draws them; ``lead`` prepends (B, nc)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(lead + (c, H, P)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, lead + (c, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    B_ = (rng.standard_normal(lead + (c, N)) * 0.3).astype(np.float32)
    C_ = (rng.standard_normal(lead + (c, N)) * 0.3).astype(np.float32)
    return pair(x, dtype), pair(dt), pair(A), pair(B_), pair(C_)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,H,P,N", [(16, 2, 32, 16), (64, 4, 64, 32)])
def test_ssd_chunk_plain_matches_pallas_and_oracle(dtype, c, H, P, N):
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _chunk_inputs(
        c, H, P, N, dtype)
    jy, jst = ssd_chunk_pallas(jx[None, None], jdt[None, None], jA,
                               jB[None, None], jC[None, None], interpret=True)
    before = SSD.launches
    ty, tst = ops.ssd_chunk(tx[None, None], tdt[None, None], tA,
                            tB[None, None], tC[None, None])
    assert SSD.launches == before                       # CPU: plain version
    assert ty.dtype == tx.dtype and tst.dtype == torch.float32
    assert tst.shape == (1, 1, H, N, P)
    np.testing.assert_allclose(f32(ty), f32(jy), **ULP[dtype])
    np.testing.assert_allclose(f32(tst), f32(jst), **SAME)
    want_y, want_h = tref.reference_ssd_chunk(tx, tdt, tA, tB, tC)
    np.testing.assert_allclose(f32(ty[0, 0]), f32(want_y), **ORACLE_TOL[dtype])
    np.testing.assert_allclose(f32(tst[0, 0]),
                               f32(want_h).transpose(0, 2, 1),
                               **ORACLE_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_ssd_chunk_matches_jax(dtype):
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _chunk_inputs(
        16, 2, 32, 16, dtype, seed=5)
    ty, th = tref.reference_ssd_chunk(tx, tdt, tA, tB, tC)
    jy, jh = jref.reference_ssd_chunk(jx, jdt, jA, jB, jC)
    assert ty.dtype == tx.dtype
    np.testing.assert_allclose(f32(ty), f32(jy), **ULP[dtype])
    np.testing.assert_allclose(f32(th), f32(jh), **SAME)


def test_ssd_chunk_plain_is_differentiable_and_finite_at_strong_decay():
    """A large dt·|A| makes exp(cum_i − cum_j) overflow above the diagonal;
    the plain version never forms it, so values and gradients stay
    finite."""
    (_, x), (_, dt), (_, A), (_, B_), (_, C_) = _chunk_inputs(
        64, 2, 16, 8, "float32", lead=(1, 1))
    dt = (dt * 400.0).requires_grad_(True)
    x.requires_grad_(True)
    y, st = ops.ssd_chunk(x, dt, A, B_, C_)
    (y.sum() + st.sum()).backward()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert torch.isfinite(x.grad).all() and torch.isfinite(dt.grad).all()


def _seq_inputs(Bb, S, H, P, N, dtype, seed=4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((Bb, S, H, P)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (Bb, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    B_ = (rng.standard_normal((Bb, S, N)) * 0.3).astype(np.float32)
    C_ = (rng.standard_normal((Bb, S, N)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((Bb, H, P, N)) * 0.1).astype(np.float32)
    return (pair(x, dtype), pair(dt), pair(A), pair(B_, dtype),
            pair(C_, dtype), pair(h0))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax_twin(use_kernel, dtype, with_h0):
    """Port branch against the same JAX branch: 4 chunks of 32, 2 heads."""
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC), (jh, th) = \
        _seq_inputs(2, 128, 2, 32, 16, dtype)
    kw = dict(chunk=32, use_kernel=use_kernel)
    jy, jT = JL.ssd_chunked(jx, jdt, jA, jB, jC,
                            h0=jh if with_h0 else None, **kw)
    ty, tT = TL.ssd_chunked(tx, tdt, tA, tB, tC,
                            h0=th if with_h0 else None, **kw)
    assert ty.dtype == tx.dtype and tT.dtype == torch.float32
    np.testing.assert_allclose(f32(ty), f32(jy), **ULP[dtype])
    np.testing.assert_allclose(f32(tT), f32(jT), **SAME)


def test_ssd_chunked_branches_agree_to_bf16():
    """Kernel branch against the einsum branch inside the port: only the
    intra-chunk y's bf16 rounding separates them."""
    (_, tx), (_, tdt), (_, tA), (_, tB), (_, tC), _ = _seq_inputs(
        2, 128, 2, 32, 16, "bfloat16")
    a, ha = TL.ssd_chunked(tx, tdt, tA, tB, tC, chunk=32, use_kernel=True)
    b, hb = TL.ssd_chunked(tx, tdt, tA, tB, tC, chunk=32, use_kernel=False)
    np.testing.assert_allclose(f32(a), f32(b), **BF16)
    np.testing.assert_allclose(f32(ha), f32(hb), **SAME)


def test_ssd_chunked_refuses_a_ragged_chunk():
    (_, tx), (_, tdt), (_, tA), (_, tB), (_, tC), _ = _seq_inputs(
        1, 40, 2, 8, 4, "float32")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TL.ssd_chunked(tx, tdt, tA, tB, tC, chunk=16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_decode_step_matches_jax(dtype):
    rng = np.random.default_rng(6)
    Bb, H, P, N = 3, 4, 8, 16
    jh, th = pair((rng.standard_normal((Bb, H, P, N)) * 0.3).astype(np.float32))
    jx, tx = pair(rng.standard_normal((Bb, H, P)).astype(np.float32), dtype)
    jdt, tdt = pair(rng.uniform(0.01, 0.2, (Bb, H)).astype(np.float32))
    jA, tA = pair(-rng.uniform(0.5, 2.0, (H,)).astype(np.float32))
    jB, tB = pair(rng.standard_normal((Bb, N)).astype(np.float32), dtype)
    jC, tC = pair(rng.standard_normal((Bb, N)).astype(np.float32), dtype)
    jy, jh2 = JL.ssd_decode_step(jh, jx, jdt, jA, jB, jC)
    ty, th2 = TL.ssd_decode_step(th, tx, tdt, tA, tB, tC)
    assert ty.dtype == tx.dtype and th2.dtype == torch.float32
    np.testing.assert_allclose(f32(ty), f32(jy), **ULP[dtype])
    np.testing.assert_allclose(f32(th2), f32(jh2), **SAME)


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_and_its_decode_step_match_jax(dtype):
    rng = np.random.default_rng(7)
    Bb, S, D, K = 2, 9, 12, 4
    jx, tx = pair(rng.standard_normal((Bb, S, D)).astype(np.float32), dtype)
    jw, tw = pair((rng.standard_normal((K, D)) * 0.5).astype(np.float32), dtype)
    jb, tb = pair((rng.standard_normal((D,)) * 0.1).astype(np.float32), dtype)
    tol = SAME if dtype == "float32" else BF16
    jy = JL.causal_conv1d(jx, jw, jb)
    ty = TL.causal_conv1d(tx, tw, tb)
    assert ty.dtype == tx.dtype
    np.testing.assert_allclose(f32(ty), f32(jy), **tol)
    # the decode step over the same sequence from a zero state
    jst = jnp.zeros((Bb, K - 1, D), jx.dtype)
    tst = torch.zeros((Bb, K - 1, D), dtype=tx.dtype)
    for t in range(S):
        jo, jst = JL.conv1d_decode(jst, jx[:, t], jw, jb)
        to, tst = TL.conv1d_decode(tst, tx[:, t], tw, tb)
        np.testing.assert_allclose(f32(to), f32(jo), **tol)
        np.testing.assert_allclose(f32(to), f32(ty[:, t]), **tol)
    np.testing.assert_array_equal(f32(tst), f32(jst))


def _hi_lo(t):
    """``t`` (f32) as the kernel feeds it to the tensor cores: bf16 hi plus
    bf16 lo = bf16(t − hi)."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float()


def tensor_core_model(x, dt, A, B_, C_):
    """The bf16 route of ``csrc/ssd_chunk.cu`` in plain torch: C·Bᵀ in f32
    from the bf16 inputs; the score factor C·Bᵀ ∘ L ∘ dt_j (L formed only
    where j ≤ i) and the decay factor B ∘ exp(cum₋₁ − cum) ∘ dt rounded to
    bf16 hi + lo; x, exact in bf16, times the rounded factor summed in f32;
    y cast once to x's dtype."""
    c = x.shape[2]
    xf, Bf, Cf = x.float(), B_.float(), C_.float()
    cum = torch.cumsum(dt * A, dim=2)                           # (B,k,c,H)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,k,i,j,H)
    tril = torch.ones((c, c), dtype=torch.bool).tril()
    L = torch.exp(diff.masked_fill(~tril[:, :, None], float("-inf")))
    cb = torch.einsum("bkin,bkjn->bkij", Cf, Bf)
    score = cb[..., None] * L * dt[:, :, None, :, :]
    y = torch.einsum("bkijh,bkjhp->bkihp", _hi_lo(score), xf)
    wd = torch.exp(cum[:, :, -1:, :] - cum) * dt                # (B,k,j,H)
    decay = Bf[..., None] * wd[:, :, :, None, :]                # (B,k,j,N,H)
    st = torch.einsum("bkjnh,bkjhp->bkhnp", _hi_lo(decay), xf)
    return y.to(x.dtype), st


@pytest.mark.parametrize("c,H,P,N", [
    (128, 2, 64, 128),   # the serving path's chunk, head dim and state
    (32, 3, 64, 64),     # the edge cases' short chunk and narrow state
])
def test_ssd_tensor_core_rounding_matches_pallas(c, H, P, N):
    """bf16 x, B and C: with hi + lo factors y stays within one bf16 ulp of
    the Pallas kernel and the f32 state within 1e-3."""
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _chunk_inputs(
        c, H, P, N, "bfloat16", lead=(1, 1))
    jB, jC = jB.astype(jnp.bfloat16), jC.astype(jnp.bfloat16)
    tB, tC = tB.bfloat16(), tC.bfloat16()
    jy, jst = ssd_chunk_pallas(jx, jdt, jA, jB, jC, interpret=True)
    ty, tst = tensor_core_model(tx, tdt, tA, tB, tC)
    assert ty.dtype == torch.bfloat16 and tst.dtype == torch.float32
    np.testing.assert_allclose(f32(ty), f32(jy), **ULP["bfloat16"])
    np.testing.assert_allclose(f32(tst), f32(jst), **ORACLE_TOL["float32"])


def test_ssd_kernel_route_follows_dtype():
    """bf16 x with bf16 B/C takes the tensor-core route; every other mix
    keeps the CUDA-core kernel."""
    bf, f = torch.bfloat16, torch.float32
    assert SSD.route(bf, bf) == "tensor_cores"
    for x_dt, bc_dt in ((f, f), (bf, f), (f, bf)):
        assert SSD.route(x_dt, bc_dt) == "cuda_cores"
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        SSD.route(torch.float16, bf)


def test_ssd_tensor_core_route_fits_two_blocks_per_sm():
    """At the serving shape (c 128, P 64, N 128) a block of the tensor-core
    route takes 112 KB, so two fit in an H100 SM's 228 KB with 1 KB reserved
    per block; the widest shape the route takes still fits one."""
    assert SSD.smem_bytes(128, 64, 128, tensor_cores=True) == 114688
    assert 2 * (114688 + 1024) <= 228 * 1024
    assert SSD.smem_bytes(128, SSD.TC_MAX_P, SSD.TC_MAX_N,
                          tensor_cores=True) <= SSD.MAX_SMEM
    # a short chunk with a wide state: the staged C tile (16 × 136 bf16)
    # outgrows the one-slot triangle, and sizes the space they share
    assert SSD.smem_bytes(16, 64, 128, tensor_cores=True) == \
        2 * 16 * 136 + 4 * 16 * 72 + 2 * 16 * 136 + 4 * 16 * 12


def _ssd_configs():
    from repro_torch.configs import ARCHS
    for name, cfg in sorted(ARCHS.items()):
        if cfg.family in ("ssm", "hybrid"):
            yield f"{name}-full", cfg
            yield f"{name}-reduced", cfg.reduced()


@pytest.mark.parametrize("tensor_cores", [False, True])
@pytest.mark.parametrize("label,cfg", list(_ssd_configs()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_every_config_ssd_shape_fits_the_kernel(label, cfg, tensor_cores):
    """Every config's (chunk, head dim, state) passes the kernel's shape
    arithmetic on both routes, full width and reduced."""
    from repro_torch.kernels import ssd_chunk as SSD
    SSD.check_shape(cfg.ssm_chunk, cfg.ssm_head_dim, cfg.ssm_state,
                    tensor_cores)


def test_ssd_shape_check_refuses_what_no_route_takes():
    from repro_torch.kernels import ssd_chunk as SSD
    with pytest.raises(ValueError, match="in bf16"):
        SSD.check_shape(128, 64, 256, True)
    with pytest.raises(ValueError, match="chunks up to"):
        SSD.check_shape(256, 64, 64, False)
