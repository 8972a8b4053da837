"""The update kernels' plain versions and oracles against the JAX package.

Each plain version (``repro_torch.kernels.async_update.*_plain``: the CPU
route, and what the CUDA kernel is held to on the card) is compared with
its Pallas kernel in interpret mode, and each port oracle
(``repro_torch.kernels.ref``) with its JAX oracle, on the same numpy
inputs, over the case matrices of ``tests/test_kernels.py`` and at its
tolerances (f32 2e-4 for the SGD and heavy-ball kernels, rtol 1e-5 for
Adam, bf16 3e-2).
The buffer swap is bitwise.  Kernels and oracles are not paired with each
other: the oracles cast Adam's step to the param dtype before subtracting,
the kernels subtract in f32.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                        # noqa: E402

from repro.kernels import ref as jref                          # noqa: E402
from repro.kernels.async_update import (                       # noqa: E402
    async_update_pallas, fused_adam_delayed_pallas, fused_adam_pallas,
    sgd_momentum_delayed_pallas, sgd_momentum_step_pallas, sgd_step_pallas)
from repro_torch.kernels import async_update as AU             # noqa: E402
from repro_torch.kernels import ops                            # noqa: E402
from repro_torch.kernels import ref as tref                    # noqa: E402
from torch_parity import f32, pair                             # noqa: E402

DTYPES = ["float32", "bfloat16"]
SGD_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
           "bfloat16": dict(rtol=3e-2, atol=3e-2)}
ADAM_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
            "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _inputs(n, dtype, seed):
    """p, m (f32), v (f32), gbuf, g as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    return {"p": pair(rng.standard_normal(n).astype(np.float32), dtype),
            "m": pair((rng.standard_normal(n) * 0.1).astype(np.float32)),
            "v": pair((rng.uniform(size=n) * 0.01).astype(np.float32)),
            "gb": pair(rng.standard_normal(n).astype(np.float32), dtype),
            "g": pair(rng.standard_normal(n).astype(np.float32), dtype)}


def _t(x):
    return {k: v[1] for k, v in x.items()}


def _j(x):
    return {k: v[0] for k, v in x.items()}


def _adam_scal(count, clip=1.0, wd=0.0, lr=1e-3):
    bc1, bc2 = AU.adam_bias_corrections(
        0.9, 0.95, torch.tensor(count, dtype=torch.int32))
    return AU.adam_scalars(lr, bc1, bc2, clip, wd, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [128 * 256, 128 * 256 + 37, 1000])
def test_async_update_plain_matches_pallas(dtype, n):
    x = _inputs(n, dtype, seed=1)
    j, t = _j(x), _t(x)
    want_p, want_b = async_update_pallas(j["p"], j["gb"], j["g"], lr=0.01,
                                         clip_scale=0.5, delay_scale=0.25,
                                         interpret=True)
    p, gb = ops.async_update(t["p"], t["gb"], t["g"],
                             AU.sgd_scalars(0.01, 0.5, 0.25, "cpu"))
    assert p is t["p"] and gb is t["gb"]                  # in place
    np.testing.assert_allclose(f32(p), f32(want_p), **SGD_TOL[dtype])
    np.testing.assert_array_equal(f32(gb), f32(want_b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [128 * 256 + 37, 100])
def test_sgd_step_plain_matches_pallas(dtype, n):
    x = _inputs(n, dtype, seed=11)
    j, t = _j(x), _t(x)
    want = sgd_step_pallas(j["p"], j["g"], lr=0.02, clip_scale=0.5,
                           delay_scale=0.25, interpret=True)
    got = ops.sgd_step(t["p"], t["g"], AU.sgd_scalars(0.02, 0.5, 0.25, "cpu"))
    np.testing.assert_allclose(f32(got), f32(want), **SGD_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("count", [1, 100])
def test_fused_adam_plain_matches_pallas(dtype, count):
    x = _inputs(4096 + 17, dtype, seed=2)
    j, t = _j(x), _t(x)
    want = fused_adam_pallas(j["p"], j["m"], j["v"], j["g"], lr=1e-3,
                             count=count, interpret=True)
    got = ops.fused_adam(t["p"], t["m"], t["v"], t["g"], _adam_scal(count))
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(b), **ADAM_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [4096 + 17, 333])
def test_fused_adam_delayed_plain_matches_pallas(dtype, n):
    x = _inputs(n, dtype, seed=7)
    j, t = _j(x), _t(x)
    want = fused_adam_delayed_pallas(j["p"], j["m"], j["v"], j["gb"], j["g"],
                                     lr=1e-3, count=5, clip_scale=0.5,
                                     weight_decay=0.01, interpret=True)
    got = ops.fused_adam_delayed(t["p"], t["m"], t["v"], t["gb"], t["g"],
                                 _adam_scal(5, clip=0.5, wd=0.01))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(f32(a), f32(b), **ADAM_TOL[dtype])
    np.testing.assert_array_equal(f32(got[3]), f32(want[3]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [128 * 256 + 37, 100])
def test_sgd_momentum_step_plain_matches_pallas(dtype, n):
    x = _inputs(n, dtype, seed=13)
    j, t = _j(x), _t(x)
    want = sgd_momentum_step_pallas(j["p"], j["m"], j["g"], lr=0.02,
                                    momentum=0.9, clip_scale=0.5,
                                    delay_scale=0.25, interpret=True)
    got = ops.sgd_momentum_step(t["p"], t["m"], t["g"],
                                AU.momentum_scalars(0.02, 0.5, 0.25, "cpu"),
                                momentum=0.9)
    assert got[0] is t["p"] and got[1] is t["m"]          # in place
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(b), **SGD_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [128 * 256 + 37, 333])
def test_sgd_momentum_delayed_plain_matches_pallas(dtype, n):
    x = _inputs(n, dtype, seed=17)
    j, t = _j(x), _t(x)
    want = sgd_momentum_delayed_pallas(j["p"], j["m"], j["gb"], j["g"],
                                       lr=0.02, momentum=0.9, clip_scale=0.5,
                                       delay_scale=0.25, interpret=True)
    got = ops.sgd_momentum_delayed(
        t["p"], t["m"], t["gb"], t["g"],
        AU.momentum_scalars(0.02, 0.5, 0.25, "cpu"), momentum=0.9)
    assert got[2] is t["gb"]
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(f32(a), f32(b), **SGD_TOL[dtype])
    np.testing.assert_array_equal(f32(got[2]), f32(want[2]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_momentum_oracles_match_jax(dtype):
    x = _inputs(1000, dtype, seed=19)
    j, t = _j(x), _t(x)
    kw = dict(lr=0.02, momentum=0.9, clip_scale=0.5, delay_scale=0.25)
    for a, b in zip(tref.reference_sgd_momentum(t["p"], t["m"], t["g"], **kw),
                    jref.reference_sgd_momentum(j["p"], j["m"], j["g"], **kw)):
        np.testing.assert_allclose(f32(a), f32(b), **SGD_TOL[dtype])
    got = tref.reference_sgd_momentum_delayed(t["p"], t["m"], t["gb"],
                                              t["g"], **kw)
    want = jref.reference_sgd_momentum_delayed(j["p"], j["m"], j["gb"],
                                               j["g"], **kw)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(f32(a), f32(b), **SGD_TOL[dtype])
    np.testing.assert_array_equal(f32(got[2]), f32(want[2]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_update_oracles_match_jax(dtype):
    x = _inputs(1000, dtype, seed=3)
    j, t = _j(x), _t(x)
    kw = dict(lr=0.01, clip_scale=0.5, delay_scale=0.25)
    for a, b in zip(tref.reference_async_update(t["p"], t["gb"], t["g"], **kw),
                    jref.reference_async_update(j["p"], j["gb"], j["g"], **kw)):
        np.testing.assert_allclose(f32(a), f32(b), **SGD_TOL[dtype])
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, bc1=1 - 0.9 ** 5,
              bc2=1 - 0.95 ** 5, clip_scale=0.5, weight_decay=0.01)
    for a, b in zip(tref.reference_fused_adam(t["p"], t["m"], t["v"],
                                              t["g"], **kw),
                    jref.reference_fused_adam(j["p"], j["m"], j["v"],
                                              j["g"], **kw)):
        np.testing.assert_allclose(f32(a), f32(b), **ADAM_TOL[dtype])
    got = tref.reference_fused_adam_delayed(t["p"], t["m"], t["v"], t["gb"],
                                            t["g"], **kw)
    want = jref.reference_fused_adam_delayed(j["p"], j["m"], j["v"], j["gb"],
                                             j["g"], **kw)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(f32(a), f32(b), **ADAM_TOL[dtype])
    np.testing.assert_array_equal(f32(got[3]), f32(want[3]))


def test_bias_corrections_and_scalars_match_the_jax_wrapper():
    c = torch.tensor(7, dtype=torch.int32)
    bc1, bc2 = AU.adam_bias_corrections(0.9, 0.95, c)
    c32 = jnp.asarray(7).astype(jnp.float32)
    np.testing.assert_allclose(bc1.item(), float(1.0 - 0.9 ** c32), rtol=1e-6)
    np.testing.assert_allclose(bc2.item(), float(1.0 - 0.95 ** c32), rtol=1e-6)
    # every block ends with the guard rails' run flag, 1 unless given
    scal = AU.adam_scalars(1e-3, bc1, bc2, 0.5, 0.1, "cpu")
    assert scal.dtype == torch.float32 and scal.shape == (6,)
    assert scal[-1].item() == 1.0
    eff = AU.sgd_scalars(0.01, torch.tensor(0.5), 0.25, "cpu")
    assert eff.shape == (2,) and eff.dtype == torch.float32
    np.testing.assert_allclose(eff[0].item(), 0.01 * 0.5 * 0.25, rtol=1e-7)
    assert eff[1].item() == 1.0
    mom = AU.momentum_scalars(0.01, torch.tensor(0.5), 0.25, "cpu",
                              run=torch.tensor(0.0))
    assert mom.shape == (3,) and mom.dtype == torch.float32
    np.testing.assert_allclose(mom.numpy(), [0.01 * 0.25, 0.5, 0.0],
                               rtol=1e-7)


def test_cpu_route_counts_no_launch_and_unknown_devices_raise():
    x = _t(_inputs(64, "float32", seed=0))
    before = dict(AU.launches)
    ops.fused_adam_delayed(x["p"], x["m"], x["v"], x["gb"], x["g"],
                           _adam_scal(1))
    assert AU.launches == before
    # meta (the dry-run's trace) takes the plain route and computes nothing
    meta = torch.empty(4, device="meta")
    assert ops.sgd_step(meta, meta, torch.empty(2, device="meta")) is meta
    other = types.SimpleNamespace(device=torch.device("mps"))
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ops.sgd_step(other, other, other)
    with pytest.raises(ValueError, match="CUDA"):
        AU.sgd_step_cuda(x["p"], x["g"], AU.sgd_scalars(0.1, 1.0, 1.0, "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        AU.sgd_momentum_delayed_cuda(
            x["p"], x["m"], x["gb"], x["g"],
            AU.momentum_scalars(0.1, 1.0, 1.0, "cpu"), momentum=0.9)


# ---------------------------------------------------------------------------
# the guard rails' run flag
# ---------------------------------------------------------------------------
_OPERANDS = {"async_update": ("p", "gb", "g"), "sgd_step": ("p", "g"),
             "sgd_momentum_step": ("p", "m", "g"),
             "sgd_momentum_delayed": ("p", "m", "gb", "g"),
             "fused_adam": ("p", "m", "v", "g"),
             "fused_adam_delayed": ("p", "m", "v", "gb", "g")}


def _flagged_scalars(name, run):
    if "adam" in name:
        bc1, bc2 = AU.adam_bias_corrections(
            0.9, 0.95, torch.tensor(3, dtype=torch.int32))
        return AU.adam_scalars(1e-3, bc1, bc2, 0.5, 0.01, "cpu", run=run)
    if "momentum" in name:
        return AU.momentum_scalars(0.02, 0.5, 0.25, "cpu", run=run)
    return AU.sgd_scalars(0.02, 0.5, 0.25, "cpu", run=run)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
        t.view(torch.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", AU.KERNELS)
def test_run_flag_zero_writes_nothing_on_nan_grads(name, dtype):
    """At run 0 every plain version leaves p, m, v and gbuf bit-identical
    to its input although g is NaN (the stale gbuf is not replaced); an
    explicit run 1 computes what the default does, bit for bit."""
    n = 128 * 256 + 37
    base = _t(_inputs(n, dtype, seed=23))
    base["g"][::3] = float("nan")
    kw = {"momentum": 0.9} if "momentum" in name else {}
    fn = getattr(AU, f"{name}_plain")
    keys = _OPERANDS[name]
    skipped = {k: v.clone() for k, v in base.items()}
    fn(*(skipped[k] for k in keys), _flagged_scalars(name, torch.tensor(0.)),
       **kw)
    for k in keys:
        assert torch.equal(_bits(skipped[k]), _bits(base[k])), k
    clean = _t(_inputs(n, dtype, seed=29))
    one, default = ({k: v.clone() for k, v in clean.items()}
                    for _ in range(2))
    fn(*(one[k] for k in keys), _flagged_scalars(name, torch.tensor(1.)),
       **kw)
    fn(*(default[k] for k in keys), _flagged_scalars(name, 1.0), **kw)
    for k in keys:
        assert torch.equal(_bits(one[k]), _bits(default[k])), k
    if "gb" in keys:
        assert torch.equal(_bits(one["gb"]), _bits(clean["g"]))
