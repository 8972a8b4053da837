"""The port's theory module and estimators, held to the JAX package.

``repro_torch.core.theory`` is a verbatim copy (``math`` only): every
``RATES`` entry and tuned stepsize must equal the JAX package's exactly.
The estimators of ``repro_torch.core.trace`` run over the port's
``per_worker_grad_fn`` on the same snapshots as the JAX ones, within the
replay suite's rtol 1e-5 / atol 1e-6, and the proofs' bounds hold on the
port's own replays (``tests/test_theory.py:95-138``).
"""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                      # noqa: E402

import repro.core.theory as jtheory                          # noqa: E402
import repro.core.trace as jtrace                            # noqa: E402
import repro.objectives as jobj                              # noqa: E402

from repro_torch import core, objectives                     # noqa: E402
from repro_torch.core import theory, trace                   # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
CONSTANTS = [dict(L=1.0, F0=1.0, sigma2=1.0, zeta2=0.5, G=2.0),
             dict(L=2.5, F0=0.3, sigma2=0.0, zeta2=4.0, G=0.1),
             dict(L=0.7, F0=12.0, sigma2=3.0, zeta2=0.0, G=1.5)]
SCHEDULE = dict(T=3000, tau_c=10, tau_max=77, b=4, n=10)


def _call(fn, c, **kw):
    """``fn`` on its own signature's subset of SCHEDULE (+ ``kw``)."""
    names = list(inspect.signature(fn).parameters)[1:]
    args = {k: v for k, v in {**SCHEDULE, **kw}.items() if k in names}
    return fn(c, **args)


@pytest.mark.parametrize("consts", CONSTANTS)
def test_rates_and_stepsizes_equal_jax_exactly(consts):
    assert sorted(theory.RATES) == sorted(jtheory.RATES)
    c, jc = theory.ProblemConstants(**consts), jtheory.ProblemConstants(**consts)
    for name in theory.RATES:
        assert _call(theory.RATES[name], c) == _call(jtheory.RATES[name], jc)
    for bg in (False, True):
        for fn in ("pure_async", "pure_async_waiting"):
            assert _call(getattr(theory, fn), c, bounded_grad=bg) == \
                _call(getattr(jtheory, fn), jc, bounded_grad=bg)
    for fn in ("stepsize_pure_async", "stepsize_random_async",
               "stepsize_shuffled_async"):
        assert _call(getattr(theory, fn), c) == _call(getattr(jtheory, fn), jc)
    for zeta in (0.1, 3.0, 50.0):
        assert theory.shuffled_beats_random(zeta, 100, 1e-2) == \
            jtheory.shuffled_beats_random(zeta, 100, 1e-2)


def test_theory_module_is_a_verbatim_copy():
    assert inspect.getsource(theory) == inspect.getsource(jtheory)


def test_requires_bounded_gradients():
    c = theory.ProblemConstants(L=1.0, F0=1.0, sigma2=1.0, zeta2=0.5, G=0.0)
    with pytest.raises(ValueError):
        theory.random_async(c, 100, 4)
    assert theory.sgd_rr(theory.ProblemConstants(2.0, 3.0, 0.0, 4.0), 5000, 7) \
        == pytest.approx(2.0 * 3.0 * 7 / 5000
                         + (2.0 * 3.0 * math.sqrt(7) * 2.0 / 5000) ** (2 / 3))


# ---- Defs 3–4 estimators --------------------------------------------------
def _quads(n=6, d=4, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    c = scale * rng.normal(size=(n, d))
    return jobj.QuadraticProblem(c), objectives.QuadraticProblem(c,
                                                                 device="cpu")


def _logregs():
    A, b = objectives.make_synthetic(1.0, 1.0, n=6, m=20, d=8, seed=2)
    return (jobj.LogRegProblem(A, b, lam=0.1),
            objectives.LogRegProblem(A, b, lam=0.1, device="cpu"))


def _pure(n, T, speeds=None):
    speeds = core.heterogeneous_speeds(n) if speeds is None else speeds
    return core.build_schedule(core.PureAsync(n),
                               core.TimingModel(speeds, "fixed"), T)


@pytest.mark.parametrize("make", [_quads, _logregs])
def test_estimators_match_jax(make):
    jp, tp = make()
    n, d = tp.n, tp.d
    s = _pure(n, 60)
    xs = core.replay(s, tp.grad_fn(), np.zeros(d), 0.01, log_every=1,
                     device="cpu").xs
    jg, tg = jp.per_worker_grad_fn(), tp.per_worker_grad_fn()
    for x in (np.zeros(d, np.float32), xs[-1]):
        np.testing.assert_allclose(
            trace.heterogeneity_zeta(tg, x, n),
            jtrace.heterogeneity_zeta(jg, jnp.asarray(x), n), **TOL)
    np.testing.assert_allclose(
        trace.sequence_correlation(s, tg, xs[::12], 12),
        jtrace.sequence_correlation(s, jg, xs[::12], 12), **TOL)
    np.testing.assert_allclose(trace.delay_variance(s, tg, xs),
                               jtrace.delay_variance(s, jg, xs), **TOL)


def test_sequence_correlation_bound_pure_async():
    """Prop. C.1: σ²_{k,τ} ≤ τ²ζ² for any realised order."""
    _, prob = _quads()
    s = _pure(prob.n, 120)
    res = core.replay(s, prob.grad_fn(), np.zeros(prob.d), 0.01, log_every=1,
                      device="cpu")
    g = prob.per_worker_grad_fn()
    sig = trace.sequence_correlation(s, g, res.xs[::12], 12)
    zeta = trace.heterogeneity_zeta(g, res.xs[0], prob.n)
    assert np.all(sig <= 12 ** 2 * zeta ** 2 + 1e-4)


def test_delay_variance_bound_pure_async():
    """Prop. C.1: ν² ≤ τ_C · τ_max · ζ² · T."""
    _, prob = _quads()
    s = _pure(prob.n, 60)
    res = core.replay(s, prob.grad_fn(), np.zeros(prob.d), 0.01, log_every=1,
                      device="cpu")
    g = prob.per_worker_grad_fn()
    nu2 = trace.delay_variance(s, g, res.xs)
    zeta = trace.heterogeneity_zeta(g, np.zeros(prob.d), prob.n)
    assert nu2 <= s.tau_c() * s.tau_max() * zeta ** 2 * 60 + 1e-4


def test_shuffled_lower_sequence_correlation_than_worst_case():
    _, prob = _quads(scale=5.0)
    n = prob.n
    s = core.build_schedule(core.ShuffledAsync(n),
                            core.TimingModel(np.ones(n), "fixed"), 10 * n)
    res = core.replay(s, prob.grad_fn(), np.zeros(prob.d), 0.005,
                      log_every=1, device="cpu")
    g = prob.per_worker_grad_fn()
    sig = trace.sequence_correlation(s, g, res.xs[::n], n)
    zeta = trace.heterogeneity_zeta(g, np.zeros(prob.d), n)
    assert np.mean(sig) <= n * zeta ** 2 + 1e-4


def test_summarize_is_the_jax_summary():
    s = _pure(5, 50)
    assert trace.summarize(s) == jtrace.summarize(s)
