"""The trainer's tap lane, divergence breaker, γ-grid lane and ``remat``
against the JAX package.

The JAX side runs its scan executor (``tests/test_runtime.py``'s micro
transformer: 1 layer, d 64, vocab 97) in float32; the port runs the same
arch from the JAX run's initial params on the JAX run's device-synthesised
batches (``batch_fn``), so only the arithmetic differs.  JAX's own suite
holds its lanes to each other at rtol 1e-5 / atol 1e-7
(``tests/test_runtime.py:53``), within one framework; across the two the
curves are held to the JAX package's trainer-curve tolerance, rtol 5e-3
(``tests/test_optim_fused.py:285-286``, with atol 1e-6 for the zero grad
norm of round 0, as ``tests/test_torch_train_backend.py`` holds it): the
frameworks reduce in other orders, and Adam's normalised step turns the
ulp-level differences of near-zero gradients into 1e-3-relative grad-norm
differences after a few rounds.  The remat loss and grads are held to
``tests/test_torch_trainer.py``'s f32 bound, rtol 1e-4 / atol 1e-5.
Within the port the lanes are held bit for bit: tap rows equal chunk
rows, a grid point equals its solo run, a resumed grid equals the
uninterrupted one, remat equals no remat.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
from jax.sharding import Mesh                                  # noqa: E402

from repro.api import ExperimentSpec as JSpec                  # noqa: E402
from repro.api import TrainerBackend as JBackend               # noqa: E402
from repro.api import TrainJob as JTrainJob                    # noqa: E402
from repro.distributed import AsyncConfig as JAsyncConfig      # noqa: E402
from repro.distributed import AsyncTrainer as JTrainer         # noqa: E402
from repro.faults import DivergenceBreaker as JBreaker         # noqa: E402
from repro.models import model as JM                           # noqa: E402
from repro.optim import OptConfig as JOptConfig                # noqa: E402
from repro.runtime import PlanExecutor as JExecutor            # noqa: E402
from repro.runtime import compile_plan as j_compile_plan       # noqa: E402
from repro.runtime import make_batch_fn as j_make_batch_fn     # noqa: E402
from repro_torch.api import ExperimentSpec, TrainerBackend, TrainJob  # noqa: E402
from repro_torch.checkpoint import AsyncSnapshotter, restore   # noqa: E402
from repro_torch.distributed import AsyncTrainer                # noqa: E402
from repro_torch.faults import DivergenceBreaker               # noqa: E402
from repro_torch.models import model as TM                     # noqa: E402
from repro_torch.optim import OptConfig                        # noqa: E402
from repro_torch.runtime import (METRICS, PlanExecutor,        # noqa: E402
                                 RunPlan, compile_plan)
from repro_torch.tree import tree_leaves                       # noqa: E402
from torch_parity import f32, port_params                      # noqa: E402

MICRO = (("n_layers", 1), ("d_model", 64), ("n_heads", 2), ("n_kv_heads", 1),
         ("d_ff", 64), ("vocab", 97), ("dtype", "float32"))
TOL = dict(rtol=5e-3, atol=1e-6)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
#: exact-binary γ ratios, as tests/test_runtime.py picks them
GRID_GAMMAS = (3e-3, 1.5e-3, 7.5e-4, 3.75e-4)
CORRUPT = "corrupt_receipt:k=3,scale=1e4,every=4,span=2"
MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _jobs(**kw):
    base = dict(global_batch=8, seq_len=16, arch_overrides=MICRO, **kw)
    return JTrainJob(**base), TrainJob(**base)


def _specs(T, scenario=None, **kw):
    jjob, tjob = _jobs()
    base = dict(scheduler="shuffled", timing="poisson:slow=6", T=T,
                n_workers=4, seed=0, stepsize=3e-3, scenario=scenario)
    base.update(kw)
    return JSpec(objective=jjob, **base), ExperimentSpec(objective=tjob,
                                                         **base)


def _plans(jspec, tspec, grid=None):
    """(JAX plan, port plan) from the same realised world."""
    jw = JBackend.world_for(jspec, 4)
    tw = TrainerBackend.world_for(tspec, 4)
    kw = dict(rounds=jspec.T, n_groups=4, seed=0, grid_gammas=grid)
    jplan = j_compile_plan(jw.schedule, jspec.objective,
                           availability=jw.availability,
                           fault_gain=jw.fault_gain, **kw)
    tplan = compile_plan(tw.schedule, tspec.objective,
                         availability=tw.availability,
                         fault_gain=tw.fault_gain, **kw)
    return jplan, tplan


def _trainers(jspec, tspec, lr=3e-3, impl="pallas"):
    """(JAX trainer, its init state), (port trainer, a maker of the same
    init state)."""
    jt = JTrainer(jspec.objective.make_arch(), MESH,
                  opt=JOptConfig(lr=lr, clip_norm=1.0),
                  async_cfg=JAsyncConfig(delay_rounds=1))
    jt.n_groups = 4
    tr = AsyncTrainer(tspec.objective.make_arch(),
                      opt=OptConfig(lr=lr, clip_norm=1.0, update_impl=impl),
                      device="cpu")
    tr.n_groups = 4
    jstate = jt.init_state(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jt.params_of(jstate))
    return (jt, jstate), (tr, lambda: tr.init_state(params=port_params(
        params)))


def _batches(jplan, cfg):
    batch_of = jax.jit(j_make_batch_fn(jplan, cfg))
    toks = [np.asarray(batch_of(jnp.asarray(k))["tokens"])
            for k in jplan.data_keys]
    return lambda q: {"tokens": toks[q]}


@pytest.fixture(scope="module")
def world6():
    jspec, tspec = _specs(6)
    jplan, tplan = _plans(jspec, tspec)
    (jt, jstate), (tr, init) = _trainers(jspec, tspec)
    jex = JExecutor(jt, jplan, donate=False)
    want = jex.run_scan(jstate, rounds_per_launch=6)
    ex = PlanExecutor(tr, tplan, batch_fn=_batches(jplan, jt.cfg))
    return want, ex, init


# ---------------------------------------------------------------------------
# tap
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [6, 4])
def test_tap_streams_every_round_like_jax(world6, k):
    """K = T (one launch for the whole run) and a ragged K = 4: one row
    per round in order, ``state=None``, no host sync, the JAX curves, and
    rows bit-equal to the chunk transport's."""
    want, ex, init = world6
    seen = []
    got = ex.run_scan(init(), rounds_per_launch=k, metrics="tap",
                      on_step=lambda i, st, m: seen.append((i, st,
                                                            m["loss"])))
    assert [i for i, _, _ in seen] == list(range(6))
    assert all(st is None for _, st, _ in seen)
    assert (got.launches, got.host_syncs, got.tap_events) == \
        (-(-6 // k), 0, 6)
    for name in METRICS:
        np.testing.assert_allclose(got.metrics[name], want.metrics[name],
                                   err_msg=name, **TOL)
    chunk = ex.run_scan(init(), rounds_per_launch=k)
    for name in METRICS:
        np.testing.assert_array_equal(got.metrics[name], chunk.metrics[name])
    np.testing.assert_array_equal([m for _, _, m in seen],
                                  chunk.metrics["loss"])


def test_tap_row_drop_fails_loudly(world6):
    """A row that never reaches the host aborts the run with the
    delivered/expected accounting, as in the JAX package."""
    _, ex, init = world6
    orig = ex._emit_tap
    ex._emit_tap = lambda i, row: None if int(i) == 2 else orig(i, row)
    try:
        with pytest.raises(RuntimeError, match=r"delivered 5/6 rows"):
            ex.run_scan(init(), rounds_per_launch=3, metrics="tap")
    finally:
        del ex._emit_tap


def test_traced_tap_run_marks_every_round(world6):
    from repro_torch.obs import Recorder

    _, ex, init = world6
    rec = Recorder()
    ex.recorder = rec
    try:
        ex.run_scan(init(), rounds_per_launch=4, metrics="tap")
    finally:
        ex.recorder = None
    rounds = [e["args"]["round"] for e in
              rec.tracer.chrome_trace()["traceEvents"]
              if e["name"] == "tap_round"]
    assert rounds == list(range(6))


# ---------------------------------------------------------------------------
# the divergence breaker
# ---------------------------------------------------------------------------
def test_breaker_trips_through_tap_and_truncates_like_jax():
    """Corrupt receipts spike the loss; the breaker on the tap lane trips
    in both packages at the same round, and the curves cover whole chunks
    only, past the trip."""
    jspec, tspec = _specs(24, scenario=CORRUPT)
    jplan, tplan = _plans(jspec, tspec)
    (jt, jstate), (tr, init) = _trainers(jspec, tspec)
    jbr, br = JBreaker(window=3, factor=5.0), DivergenceBreaker(3, 5.0)
    want = JExecutor(jt, jplan).run_scan(jstate, rounds_per_launch=4,
                                         metrics="tap", breaker=jbr)
    ex = PlanExecutor(tr, tplan, batch_fn=_batches(jplan, jt.cfg))
    got = ex.run_scan(init(), rounds_per_launch=4, metrics="tap",
                      breaker=br)
    n = len(got.metrics["loss"])
    assert got.stats.tripped_round == want.stats.tripped_round \
        == br.tripped_round is not None
    assert n % 4 == 0 and got.stats.tripped_round < n <= 24
    assert n == len(want.metrics["loss"])
    assert got.tap_events == n and got.launches == n // 4
    assert got.metrics["loss"].max() > 5.0 * got.metrics["loss"].min()
    trip = got.stats.tripped_round
    np.testing.assert_allclose(got.metrics["loss"][:trip],
                               want.metrics["loss"][:trip], **TOL)
    with pytest.raises(ValueError, match="tap"):
        ex.run_scan(init(), metrics="chunk", breaker=DivergenceBreaker())
    # through the backend: accepted, and the trip is reported
    br2 = DivergenceBreaker(window=2, factor=2.0)
    _, spec2 = _specs(8, scenario="corrupt_receipt:k=3,scale=1e4,every=2,"
                                  "span=1", runtime="scan",
                      rounds_per_launch=2, metrics="tap")
    res = TrainerBackend("cpu", breaker=br2).run(spec2)
    assert br2.tripped and res.extra["tripped_round"] == br2.tripped_round
    assert res.extra["metrics_mode"] == "tap"


# ---------------------------------------------------------------------------
# the γ-grid lane
# ---------------------------------------------------------------------------
def test_grid_plan_lowering_and_validation_match_jax():
    jspec, tspec = _specs(5)
    jplan, tplan = _plans(jspec, tspec, grid=GRID_GAMMAS)
    assert tplan.n_grid == 4 and tplan.grid_scales.shape == (4, 5)
    np.testing.assert_array_equal(tplan.grid_scales, jplan.grid_scales)
    assert tplan.grid_scales.dtype == jplan.grid_scales.dtype
    np.testing.assert_array_equal(tplan.grid_slice(1, 3),
                                  np.asarray(jplan.grid_slice(1, 3)))
    assert tplan.summary() == jplan.summary() and \
        tplan.summary()["n_grid"] == 4
    single = _plans(jspec, tspec)[1]
    assert single.n_grid == 0
    with pytest.raises(ValueError, match="γ-axis"):
        single.grid_slice(0, 2)
    with pytest.raises(ValueError, match="grid_scales"):
        RunPlan(masks=tplan.masks, delay_scales=tplan.delay_scales,
                data_keys=tplan.data_keys, token_cdf=tplan.token_cdf,
                group_perms=tplan.group_perms, global_batch=8, seq_len=16,
                seed=0, grid_scales=tplan.grid_scales[:, :3])
    with pytest.raises(ValueError, match="grid_gammas"):
        compile_plan(TrainerBackend.world_for(tspec, 4).schedule,
                     tspec.objective, rounds=5, n_groups=4, grid_gammas=())


@pytest.fixture(scope="module")
def grid6():
    jspec, tspec = _specs(6)
    jplan, tplan = _plans(jspec, tspec, grid=GRID_GAMMAS)
    (jt, jstate), (tr, init) = _trainers(jspec, tspec)
    want = JExecutor(jt, jplan).run_grid(jstate, rounds_per_launch=4)
    return jplan, tplan, want, tspec, _batches(jplan, jt.cfg), init


@pytest.mark.parametrize("impl", ["pallas", "pallas_pooled"])
def test_run_grid_equals_solo_runs_bitwise_and_jax(grid6, impl):
    """Point i of one grid run equals a solo scan run on a trainer built
    at γ_i, bit for bit (curves and final state), and the grid's curves
    agree with the JAX vmapped grid lane."""
    jplan, tplan, want, tspec, batch_fn, init = grid6
    (_, _), (tr, init) = _trainers(_specs(6)[0], tspec, impl=impl)
    ex = PlanExecutor(tr, tplan, batch_fn=batch_fn)
    got = ex.run_grid(init(), rounds_per_launch=4)         # ragged: 4 + 2
    assert got.metrics["loss"].shape == (4, 6)
    assert (got.launches, got.host_syncs) == (2, 1)
    assert not np.allclose(got.metrics["loss"][0], got.metrics["loss"][3],
                           rtol=1e-6)
    for name in METRICS:
        np.testing.assert_allclose(got.metrics[name],
                                   np.asarray(want.metrics[name]),
                                   err_msg=name, **TOL)
    solo_plan = _plans(_specs(6)[0], tspec)[1]
    for i, g in enumerate(GRID_GAMMAS):
        (_, _), (tri, init_i) = _trainers(_specs(6)[0], tspec, lr=g,
                                          impl=impl)
        solo = PlanExecutor(tri, solo_plan, batch_fn=batch_fn).run_scan(
            init_i(), rounds_per_launch=4)
        for name in METRICS:
            np.testing.assert_array_equal(got.metrics[name][i],
                                          solo.metrics[name], err_msg=name)
        for a, b in zip(tree_leaves(got.state), tree_leaves(solo.state)):
            assert torch.equal(a[i], b)
    with pytest.raises(ValueError, match="grid"):
        got.rows


def test_run_grid_snapshot_resume_midgrid_and_modes(grid6, tmp_path):
    """A grid run snapshotted mid-run restores as the stacked state and
    resumes bit for bit; ``"none"`` runs, ``"tap"`` and a plan without a
    γ-axis are refused, as in the JAX package."""
    _, tplan, _, tspec, batch_fn, _ = grid6
    (_, _), (tr, init) = _trainers(_specs(6)[0], tspec,
                                   impl="pallas_pooled")
    ex = PlanExecutor(tr, tplan, batch_fn=batch_fn)
    snap = AsyncSnapshotter(str(tmp_path / "grid"), 2, keep=4)
    full = ex.run_grid(init(), rounds_per_launch=2, snapshot=snap)
    assert full.stats.snapshots == 3                   # rounds 2, 4, 6
    restored = restore(str(tmp_path / "grid" / "round-00000002"),
                       ex.stack_state(init()))
    assert restored["step"].tolist() == [2] * 4
    tail = ex.run_grid(restored, rounds_per_launch=2, start_round=2)
    np.testing.assert_array_equal(tail.metrics["loss"],
                                  full.metrics["loss"][:, 2:])
    for a, b in zip(tree_leaves(full.state), tree_leaves(tail.state)):
        assert torch.equal(a, b)
    none = ex.run_grid(init(), rounds_per_launch=4, metrics="none")
    assert none.metrics == {} and none.host_syncs == 0
    for a, b in zip(tree_leaves(none.state), tree_leaves(full.state)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="tap"):
        ex.run_grid(init(), metrics="tap")
    with pytest.raises(ValueError, match="γ-axis"):
        PlanExecutor(tr, _plans(_specs(6)[0], tspec)[1],
                     batch_fn=batch_fn).run_grid(init())


def test_backend_grid_lane_matches_jax_backend():
    """A grid stepsize policy on the scan runtime goes through the grid
    lane in both packages: the same extra keys, the same winner and its
    curve."""
    jspec, tspec = _specs(4, stepsize=(2e-2, 5e-3, 1e-3),
                          rounds_per_launch=2)
    want = JBackend().run(jspec)
    jcfg = jspec.objective.make_arch()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jplan, _ = _plans(jspec, tspec, grid=(2e-2, 5e-3, 1e-3))
    got = TrainerBackend("cpu", params_fn=lambda c, d: port_params(params),
                         batch_fn=_batches(jplan, jcfg)).run(tspec)
    for k in ("grid_lane", "n_grid", "runtime", "launches", "host_syncs",
              "plan_summary", "metrics_mode"):
        assert got.extra[k] == want.extra[k], k
    assert got.gamma == want.gamma
    np.testing.assert_allclose(got.losses, want.losses, **TOL)
    for g in (2e-2, 5e-3, 1e-3):
        np.testing.assert_allclose(got.grid[g]["losses"],
                                   want.grid[g]["losses"], **TOL)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_remat_loss_and_grads_match_jax(arch):
    """``remat="full"`` against JAX's ``jax.checkpoint`` per layer, in f32
    at 2 layers: loss and grads at the trainer tolerance, and bit for bit
    what the port computes with ``remat="none"``."""
    from repro.configs import get_arch
    from repro_torch.configs import get_arch as t_get_arch

    over = dict(remat="full", dtype="float32", n_layers=2)
    jcfg = get_arch(arch).reduced().with_(**over)
    tcfg = t_get_arch(arch).reduced().with_(**over)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tok = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 32)).astype(
        np.int32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(
        jcfg, p, {"tokens": jnp.asarray(tok)})[0]))(jp)
    grads = {}
    for remat in ("full", "none"):
        tp = jax.tree_util.tree_map(lambda t: t.requires_grad_(True),
                                    port_params(jp))
        loss, _ = TM.loss_fn(tcfg.with_(remat=remat), tp,
                             {"tokens": torch.from_numpy(tok).long()})
        loss.backward()
        grads[remat] = (loss.detach(), [t.grad for t in tree_leaves(tp)])
    np.testing.assert_allclose(grads["full"][0].item(), float(jl),
                               **F32_TOL)
    for (path, want), have in zip(jax.tree_util.tree_leaves_with_path(jg),
                                  grads["full"][1]):
        np.testing.assert_allclose(f32(have), f32(want), **F32_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert torch.equal(grads["full"][0], grads["none"][0])
    for a, b in zip(grads["full"][1], grads["none"][1]):
        assert torch.equal(a, b)
