"""The port's theory tier on the CPU, held to the JAX package.

The same inputs — arrays from the (verbatim) numpy generators, schedules
from the (verbatim) engine — go through the JAX objectives, ``replay`` and
``SimulatorBackend`` and through their counterparts in ``repro_torch``.
Tolerance: rtol 1e-5 / atol 1e-6, the reference's own for replay against a
hand-rolled loop (``tests/test_simulator.py:47``).  The port's grid is held
to its own solo replays bit for bit, as ``tests/test_api.py:167-179`` holds
the JAX grid.  The JAX package's mini-batch draws (threefry) are injected
into the port's index table for the stochastic lane.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.api as japi                                     # noqa: E402
import repro.core as jcore                                   # noqa: E402
import repro.objectives as jobj                              # noqa: E402
from repro.api.result import RunResult as JaxRunResult       # noqa: E402

from repro_torch import api, core, objectives                # noqa: E402
from repro_torch.api.backends import _grid_score             # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"


def _data(n=8, m=40, d=30, seed=0):
    return objectives.make_synthetic(1.0, 1.0, n=n, m=m, d=d, seed=seed)


def _pair(n=8, m=40, d=30, seed=0, **kw):
    """(JAX problem, port problem on the CPU) on the same arrays."""
    A, b = _data(n, m, d, seed)
    return (jobj.LogRegProblem(A, b, lam=0.1, **kw),
            objectives.LogRegProblem(A, b, lam=0.1, device=CPU, **kw))


def _quads(n=6, d=5, seed=0, scale=1.0, hess=False):
    rng = np.random.default_rng(seed)
    c = scale * rng.normal(size=(n, d))
    H = None
    if hess:
        M = rng.normal(size=(n, d, d))
        H = np.eye(d) + 0.1 * np.einsum("nij,nkj->nik", M, M)
    return (jobj.QuadraticProblem(c, H),
            objectives.QuadraticProblem(c, H, device=CPU))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _schedules(scheduler, timing, n, T, seed=0, speeds=None):
    """(JAX schedule, port schedule) of one spec; equal by construction."""
    kw = dict(scheduler=scheduler, timing=timing, n_workers=n, T=T,
              seed=seed, speeds=speeds)
    js = japi.ExperimentSpec(**kw).build_schedule()
    ps = api.ExperimentSpec(**kw).build_schedule()
    np.testing.assert_array_equal(js.workers, ps.workers)
    np.testing.assert_array_equal(js.assign_iters, ps.assign_iters)
    return js, ps


def _close_replay(got, want, fields=("x", "xs", "grad_norms", "losses")):
    for f in fields:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **TOL)


# ---- objectives -----------------------------------------------------------
def test_generators_are_bit_identical():
    for args in ((1.0, 1.0), (0.5, 2.0)):
        for a, b in zip(objectives.make_synthetic(*args, n=4, m=20, d=16,
                                                  seed=3),
                        jobj.make_synthetic(*args, n=4, m=20, d=16, seed=3)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for name in ("w7a", "phishing"):
        for a, b in zip(objectives.make_libsvm_like(name, n=2, seed=1),
                        jobj.make_libsvm_like(name, n=2, seed=1)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        objectives.make_libsvm_like("a9a")


def test_logreg_losses_and_gradients_match_jax():
    jp, tp = _pair()
    rng = np.random.default_rng(0)
    for x in (np.zeros(30, np.float32),
              rng.normal(size=30).astype(np.float32)):
        jx = jnp.asarray(x)
        np.testing.assert_allclose(_np(tp.loss(x)), jp.loss(jx), **TOL)
        np.testing.assert_allclose(_np(tp.full_grad(x)), jp.full_grad(jx),
                                   **TOL)
        for w in (0, 5):
            np.testing.assert_allclose(_np(tp.local_loss(x, w)),
                                       jp.local_loss(jx, w), **TOL)
            np.testing.assert_allclose(_np(tp.local_grad(x, w)),
                                       jp.local_grad(jx, w), **TOL)
            # a 0-d tensor worker, as the replay passes it
            np.testing.assert_allclose(
                _np(tp.grad_fn()(torch.from_numpy(x), torch.tensor(w), None)),
                jp.local_grad(jx, w), **TOL)
    np.testing.assert_allclose(tp.zeta(np.zeros(30)),
                               jp.zeta(np.zeros(30)), **TOL)
    assert tp.smoothness_bound() == pytest.approx(jp.smoothness_bound(),
                                                  rel=1e-6)
    single = tp.as_single_node()
    assert (single.n, single.m, single.d) == (8 * 40, 1, 30)
    assert single.device == tp.device


def test_logreg_stochastic_grad_matches_jax_on_its_draw():
    jp, tp = _pair(batch_size=10)
    x = np.random.default_rng(1).normal(size=30).astype(np.float32)
    key = jax.random.PRNGKey(4)
    idx = np.array(jax.random.choice(key, 40, (10,), replace=False))
    want = jp.stochastic_grad(jnp.asarray(x), 3, key)
    got = tp.grad_fn(stochastic=True)(torch.from_numpy(x), torch.tensor(3),
                                      torch.from_numpy(idx))
    np.testing.assert_allclose(_np(got), want, **TOL)
    with pytest.raises(ValueError, match="index row"):
        tp.stochastic_grad(x, 3, None)


def test_batch_table_draws_distinct_rows_from_the_seed():
    _, tp = _pair(batch_size=10)
    t1 = tp.batch_table(50, torch.Generator().manual_seed(7))
    t2 = tp.batch_table(50, torch.Generator().manual_seed(7))
    assert t1.shape == (50, 10) and t1.dtype == torch.int64
    assert torch.equal(t1, t2)
    assert int(t1.min()) >= 0 and int(t1.max()) < 40
    assert all(len(set(row.tolist())) == 10 for row in t1)
    assert not torch.equal(t1, tp.batch_table(
        50, torch.Generator().manual_seed(8)))


@pytest.mark.parametrize("hess", [False, True])
def test_quadratic_matches_jax(hess):
    jq, tq = _quads(hess=hess)
    x = np.random.default_rng(2).normal(size=5).astype(np.float32)
    np.testing.assert_allclose(_np(tq.full_grad(x)),
                               jq.full_grad(jnp.asarray(x)), **TOL)
    np.testing.assert_allclose(_np(tq.loss(x)), jq.loss(jnp.asarray(x)),
                               **TOL)
    for w in range(6):
        np.testing.assert_allclose(_np(tq.local_grad(x, w)),
                                   jq.local_grad(jnp.asarray(x), w), **TOL)
    np.testing.assert_allclose(tq.minimizer(), jq.minimizer(), **TOL)


def test_objectives_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal shows only without it")
    A, b = _data()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        objectives.LogRegProblem(A, b)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        objectives.QuadraticProblem(np.zeros((2, 3)))


# ---- replay against the JAX replay ---------------------------------------
@pytest.mark.parametrize("scheduler", ["pure", "fedbuff:b=4", "shuffled"])
def test_replay_matches_jax(scheduler):
    """``tests/test_api.py:89-109``'s cases: n 8, m 40, d 30, T 120."""
    jp, tp = _pair()
    js, ps = _schedules(scheduler, "poisson:slow=8", 8, 120)
    kw = dict(log_every=20)
    want = jcore.replay(js, jp.grad_fn(), jnp.zeros(30), 0.004,
                        full_grad_fn=jp.full_grad, loss_fn=jp.loss, **kw)
    got = core.replay(ps, tp.grad_fn(), np.zeros(30, np.float32), 0.004,
                      full_grad_fn=tp.full_grad, loss_fn=tp.loss,
                      device=CPU, **kw)
    np.testing.assert_array_equal(got.log_ts, want.log_ts)
    _close_replay(got, want)
    assert got.stats == {"runtime": "eager", "graph_replays": 0,
                         "chunk_steps": None, "device": "cpu",
                         "host_syncs": 1}


def test_replay_with_clip_matches_jax():
    jp, tp = _pair()
    js, ps = _schedules("pure", "poisson:slow=8", 8, 120)
    want = jcore.replay(js, jp.grad_fn(), jnp.zeros(30), 0.05, clip=0.05,
                        log_every=10, full_grad_fn=jp.full_grad)
    got = core.replay(ps, tp.grad_fn(), np.zeros(30, np.float32), 0.05,
                      clip=0.05, log_every=10, full_grad_fn=tp.full_grad,
                      device=CPU)
    _close_replay(got, want, ("x", "xs", "grad_norms"))
    # the clip bites: the unclipped run moves elsewhere
    free = core.replay(ps, tp.grad_fn(), np.zeros(30, np.float32), 0.05,
                       log_every=10, device=CPU)
    assert not np.allclose(free.x, got.x, **TOL)


def test_replay_delay_adaptive_matches_jax():
    jp, tp = _pair()
    speeds = tuple([1.0] * 7 + [5.0])
    js, ps = _schedules("pure", "fixed", 8, 60, speeds=speeds)
    steps = core.delay_adaptive_stepsizes(0.05, ps.delays, ps.tau_c())
    np.testing.assert_array_equal(
        steps, jcore.delay_adaptive_stepsizes(0.05, js.delays, js.tau_c()))
    want = jcore.replay(js, jp.grad_fn(), jnp.zeros(30), steps, log_every=10,
                        full_grad_fn=jp.full_grad)
    got = core.replay(ps, tp.grad_fn(), np.zeros(30, np.float32), steps,
                      log_every=10, full_grad_fn=tp.full_grad, device=CPU)
    _close_replay(got, want, ("x", "xs", "grad_norms"))


def test_replay_delay_zero_schedule_matches_jax():
    """RR: τ_max = 0, so the ring has one slot and each step reads the
    iterate it has just written."""
    jp, tp = _pair()
    js, ps = _schedules("rr", "fixed", 8, 64)
    assert ps.tau_max() == 0
    want = jcore.replay(js, jp.grad_fn(), jnp.zeros(30), 0.01, log_every=8,
                        full_grad_fn=jp.full_grad)
    got = core.replay(ps, tp.grad_fn(), np.zeros(30, np.float32), 0.01,
                      log_every=8, full_grad_fn=tp.full_grad, device=CPU)
    _close_replay(got, want, ("x", "xs", "grad_norms"))


def test_replay_stochastic_matches_jax_with_injected_draws():
    """The JAX replay's key stream — ``jax.random.split(PRNGKey(seed), T)``
    and one ``choice(k, m, (bs,), replace=False)`` per step — injected as
    the port's (T, bs) mini-batch table."""
    jp, tp = _pair(batch_size=10)
    js, ps = _schedules("random", "uniform:slow=4", 8, 80, seed=5)
    keys = jax.random.split(jax.random.PRNGKey(5), 80)
    table = np.stack([np.asarray(jax.random.choice(k, 40, (10,),
                                                   replace=False))
                      for k in keys])
    want = jcore.replay(js, jp.grad_fn(stochastic=True), jnp.zeros(30), 0.01,
                        key=jax.random.PRNGKey(5), log_every=10,
                        full_grad_fn=jp.full_grad)
    got = core.replay(ps, tp.grad_fn(stochastic=True),
                      np.zeros(30, np.float32), 0.01, batch_idx=table,
                      log_every=10, full_grad_fn=tp.full_grad, device=CPU)
    _close_replay(got, want, ("x", "xs", "grad_norms"))
    with pytest.raises(ValueError, match="rows"):
        core.replay(ps, tp.grad_fn(stochastic=True), np.zeros(30), 0.01,
                    batch_idx=table[:10], device=CPU)


def test_snapshots_are_the_iterates_after_their_steps():
    _, tp = _pair()
    _, ps = _schedules("pure", "fixed", 8, 30)
    every = core.replay(ps, tp.grad_fn(), np.zeros(30, np.float32), 0.01,
                        log_every=1, device=CPU)
    sparse = core.replay(ps, tp.grad_fn(), np.zeros(30, np.float32), 0.01,
                         log_every=7, device=CPU)
    np.testing.assert_array_equal(sparse.log_ts, [0, 7, 14, 21, 28])
    np.testing.assert_array_equal(sparse.xs, every.xs[sparse.log_ts])
    np.testing.assert_array_equal(every.xs[-1], every.x)
    assert not np.array_equal(every.xs[0], np.zeros(30))


# ---- the grid -----------------------------------------------------------
GRID = (0.005, 0.002, 0.0005)


@pytest.mark.parametrize("stochastic,clip", [(False, None), (True, 0.05)])
def test_replay_grid_is_bitwise_solo_replays(stochastic, clip):
    _, tp = _pair(batch_size=10)
    _, ps = _schedules("shuffled", "poisson:slow=8", 8, 150)
    table = tp.batch_table(150, torch.Generator().manual_seed(0)) \
        if stochastic else None
    kw = dict(batch_idx=table, clip=clip, log_every=25,
              full_grad_fn=tp.full_grad, loss_fn=tp.loss, device=CPU)
    gf = tp.grad_fn(stochastic=stochastic)
    batched = core.replay_grid(ps, gf, np.zeros(30, np.float32), GRID, **kw)
    for g, res in zip(GRID, batched):
        solo = core.replay(ps, gf, np.zeros(30, np.float32), g, **kw)
        for f in ("x", "xs", "grad_norms", "losses"):
            np.testing.assert_array_equal(getattr(res, f), getattr(solo, f))


def test_replay_grid_matches_jax_grid():
    jp, tp = _pair()
    js, ps = _schedules("fedbuff:b=4", "poisson:slow=8", 8, 120)
    want = jcore.replay_grid(js, jp.grad_fn(), jnp.zeros(30), GRID,
                             log_every=20, full_grad_fn=jp.full_grad)
    got = core.replay_grid(ps, tp.grad_fn(), np.zeros(30, np.float32), GRID,
                           log_every=20, full_grad_fn=tp.full_grad,
                           device=CPU)
    for g, w in zip(got, want):
        _close_replay(g, w, ("x", "xs", "grad_norms"))


# ---- SimulatorBackend against the JAX backend ----------------------------
def _specs(jp, tp, **kw):
    return (japi.ExperimentSpec(objective=jp, **kw),
            api.ExperimentSpec(objective=tp, **kw))


def test_backend_grid_selection_matches_jax_winner():
    """``tests/test_api.py``'s selection problem, whose scores separate."""
    jp, tp = _pair(n=6, m=30, d=20, seed=1)
    jspec, tspec = _specs(jp, tp, scheduler="shuffled",
                          timing="poisson:slow=8", T=200,
                          stepsize=GRID, log_every=20, seed=0)
    want = japi.run(jspec)
    got = api.run(tspec, device=CPU)
    assert got.backend == "simulator" and got.gamma == want.gamma
    scores = sorted(want.grid[g]["score"] for g in GRID)
    assert scores[1] - scores[0] > 1e-3          # the scores separate
    for g in GRID:
        assert got.grid[g]["score"] == pytest.approx(want.grid[g]["score"],
                                                     rel=1e-5)
        np.testing.assert_allclose(got.grid[g]["grad_norms"],
                                   want.grid[g]["grad_norms"], **TOL)
    assert got.trace == want.trace
    np.testing.assert_allclose(got.x, want.x, **TOL)
    assert got.extra["host_syncs"] == 1 and got.extra["device"] == "cpu"


@pytest.mark.parametrize("stepsize", [0.004, "delay_adaptive:0.05"])
def test_backend_constant_and_adaptive_match_jax(stepsize):
    jp, tp = _pair()
    jspec, tspec = _specs(jp, tp, scheduler="pure", timing="fixed", T=60,
                          stepsize=stepsize, log_every=10,
                          speeds=tuple([1.0] * 7 + [5.0]), clip=1.0)
    want, got = japi.run(jspec), api.run(tspec, device=CPU)
    assert got.gamma == want.gamma and got.grid is None
    _close_replay(got, want)


def test_backend_stochastic_draws_from_the_seed():
    _, tp = _pair(batch_size=10)
    spec = dict(scheduler="pure", timing="fixed", objective=tp, T=40,
                stepsize=0.01, stochastic=True, log_every=10)
    r1 = api.run(api.ExperimentSpec(seed=1, **spec), device=CPU)
    r1b = api.run(api.ExperimentSpec(seed=1, **spec), device=CPU)
    r2 = api.run(api.ExperimentSpec(seed=2, **spec), device=CPU)
    np.testing.assert_array_equal(r1.x, r1b.x)
    # pure + fixed timing is seed-independent: only the noise differs
    assert not np.array_equal(r1.x, r2.x)
    table = tp.batch_table(40, torch.Generator().manual_seed(1))
    raw = core.replay(api.ExperimentSpec(seed=1, **spec).build_schedule(),
                      tp.grad_fn(stochastic=True), np.zeros(30, np.float32),
                      0.01, batch_idx=table, log_every=10, device=CPU)
    np.testing.assert_array_equal(r1.x, raw.x)


def test_backend_refusals():
    _, tp = _pair()
    with pytest.raises(TypeError, match="grad_fn"):
        api.SimulatorBackend(CPU).run(api.ExperimentSpec(objective=object(),
                                                         n_workers=2))
    with pytest.raises(ValueError, match="live on meta"):
        A, b = _data()
        meta = objectives.LogRegProblem(A, b, device="meta")
        api.SimulatorBackend(CPU).run(api.ExperimentSpec(objective=meta))

    class NoFullGrad:
        n, d, device = 8, 30, torch.device("cpu")
        grad_fn = staticmethod(tp.grad_fn)

    with pytest.raises(ValueError, match="full_grad"):
        api.run(api.ExperimentSpec(objective=NoFullGrad(), stepsize=GRID,
                                   T=10), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            api.run(api.ExperimentSpec(objective=tp, T=10))


def test_stepsize_helpers_match_jax():
    assert api.constant(0.01) == api.StepsizePolicy("constant", (0.01,))
    assert api.grid(0.01, 0.02) == api.StepsizePolicy.coerce((0.01, 0.02))
    assert api.StepsizePolicy.coerce("delay_adaptive:0.05") == \
        api.delay_adaptive(0.05)
    for p, j in ((api.constant(0.3), japi.constant(0.3)),
                 (api.grid(*GRID), japi.grid(*GRID)),
                 (api.delay_adaptive(0.1), japi.delay_adaptive(0.1))):
        assert (p.kind, p.gammas) == (j.kind, j.gammas)


def test_run_result_json_is_readable_by_jax():
    _, tp = _pair()
    res = api.run(api.ExperimentSpec(objective=tp, scheduler="shuffled",
                                     timing="poisson:slow=8", T=100,
                                     stepsize=GRID, log_every=20),
                  device=CPU)
    back = JaxRunResult.from_json(res.to_json())
    assert back.backend == "simulator" and back.gamma == res.gamma
    np.testing.assert_array_equal(back.x, res.x)
    np.testing.assert_array_equal(back.grad_norms, res.grad_norms)
    assert set(back.grid) == set(GRID)
    np.testing.assert_array_equal(back.grid[GRID[1]]["grad_norms"],
                                  res.grid[GRID[1]]["grad_norms"])
    assert back.schedule["tau_max"] == res.schedule.tau_max()
    assert back.extra["host_syncs"] == 1
    json.loads(res.to_json())


# ---- closed forms (tests/test_simulator.py:27-97) ------------------------
def test_rr_exactly_matches_classic_sgd_rr():
    _, prob = _quads()
    n, d = prob.n, prob.d
    gamma, T = 0.05, 4 * prob.n
    s = core.build_schedule(core.RandomReshuffling(n, seed=3),
                            core.TimingModel(np.ones(n), "fixed"), T)
    res = core.replay(s, prob.grad_fn(), np.zeros(d), gamma, log_every=1,
                      device=CPU)
    x = np.zeros(d, dtype=np.float32)
    for t in range(T):
        x = x - gamma * _np(prob.local_grad(x, int(s.workers[t])))
    np.testing.assert_allclose(res.x, x, **TOL)
    assert s.tau_max() == 0


def test_minibatch_exactly_matches_minibatch_sgd():
    _, prob = _quads(n=12)
    b, gamma, rounds = 4, 0.07, 10
    s = core.build_schedule(
        core.MiniBatch(prob.n, b=b, seed=5),
        core.TimingModel(np.linspace(1, 3, prob.n), "uniform", seed=1),
        b * rounds)
    res = core.replay(s, prob.grad_fn(), np.zeros(prob.d), gamma,
                      log_every=1, device=CPU)
    x = np.zeros(prob.d, dtype=np.float64)
    for q in range(rounds):
        batch = s.workers[q * b:(q + 1) * b]
        g = np.mean([_np(prob.local_grad(x.astype(np.float32), int(i)))
                     for i in batch], axis=0)
        x = x - gamma * g
    np.testing.assert_allclose(res.x, x, rtol=1e-4, atol=1e-5)


def test_pure_async_equal_speeds_is_cyclic_delayed_sgd():
    _, prob = _quads(n=4, d=3)
    gamma, T = 0.05, 40
    s = core.build_schedule(core.PureAsync(4),
                            core.TimingModel(np.ones(4), "fixed"), T)
    res = core.replay(s, prob.grad_fn(), np.zeros(3), gamma, log_every=1,
                      device=CPU)
    xs = [np.zeros(3, dtype=np.float64)]
    for t in range(T):
        pi = int(s.assign_iters[t])
        g = _np(prob.local_grad(xs[pi].astype(np.float32),
                                int(s.workers[t])))
        xs.append(xs[-1] - gamma * g)
    np.testing.assert_allclose(res.x, xs[-1], rtol=1e-4, atol=1e-5)


def test_quadratic_convergence_to_consensus_minimum():
    _, prob = _quads(n=5, d=4, seed=2)
    sched, res = core.run_async_sgd(core.PureAsync(prob.n),
                                    core.TimingModel(np.ones(prob.n),
                                                     "fixed"),
                                    prob.grad_fn(), np.zeros(prob.d), 0.02,
                                    4000, log_every=100,
                                    full_grad_fn=prob.full_grad,
                                    loss_fn=prob.loss, device=CPU)
    assert sched.T == 4000
    np.testing.assert_allclose(res.x, prob.minimizer(), atol=0.05)
    assert res.grad_norms[-1] < res.grad_norms[0]
    assert res.losses[-1] < res.losses[0]


def test_clipping_bounds_update_norm():
    _, prob = _quads(n=3, d=4, seed=1, scale=100.0)
    s = core.build_schedule(core.PureAsync(3),
                            core.TimingModel(np.ones(3), "fixed"), 10)
    res = core.replay(s, prob.grad_fn(), np.zeros(4), 1.0, clip=1.0,
                      log_every=1, device=CPU)
    steps = np.diff(np.concatenate([np.zeros((1, 4)), res.xs]), axis=0)
    assert np.all(np.linalg.norm(steps, axis=-1) <= 1.0 + 1e-5)


def test_grid_score_is_the_paper_protocol():
    gn = np.array([5.0, 4.0, 3.0, 2.0, 1.0, 1.5, 0.5])
    assert _grid_score(gn) == pytest.approx(
        np.mean(gn[-3:]) + 0.5 * np.std(gn[-5:]))
    from repro.api.backends import _grid_score as jax_score
    assert _grid_score(gn) == jax_score(gn)
