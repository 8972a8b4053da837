"""Scenario and fault channels, guard rails and the sparsifier, against JAX.

The port's ``compile_plan`` lowers a scenario world's four channels
(``availability``, ``zipf_as``, ``grad_density``, ``fault_gain``) with the
JAX package's numpy code: the plans are array-equal and reject bad
channels with the same messages.  The train step applies the channels and
the guard rails as the JAX step does, on identical state, batch and mask
(qwen2-0.5b reduced, f32 and bf16, the port's reference and fused
routes; the JAX step runs its reference update).  Tolerances are those of
``tests/test_torch_trainer.py`` (f32: rtol 1e-4 / atol 1e-5 on losses and
norms, a 1e-4 relative L2 error per state leaf, 1e-2 for the Adam k bias;
bf16: rtol 3e-2 and a 3e-2 relative L2 error), and of
``tests/test_faults.py`` for the guard channels (skips exact, health rtol
1e-6).  As there, bf16 states are not compared leaf by leaf (bf16
activations round at other places in the two frameworks): bf16 runs hold
the metrics, the skips, the health and the counters.  A sparsified step
keeps the entries of |g| above a quantile of |g|; the two frameworks'
grads differ by rounding, so entries within rounding of the threshold can
fall on either side: the kept sets must agree on all but a few entries in
a thousand (f32) or a hundred (bf16), and the kept values to the grads'
tolerance.  A skipped round is bit for bit: every leaf keeps its bits.
The sparsifier itself, on the same input, is bit-identical to the JAX
step's on a bf16 leaf of 2^24 + 3 elements, past where ``torch.quantile``
refuses (on f32 XLA's CPU compile turns the product into a select, so a
dropped zero may differ in sign), and its index arithmetic equals JAX's
f32 expression at qwen2-0.5b's embedding size.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
from jax import lax                                            # noqa: E402
from jax.sharding import Mesh                                  # noqa: E402

from repro.api import ExperimentSpec as JSpec                  # noqa: E402
from repro.api import TrainerBackend as JBackend               # noqa: E402
from repro.api import TrainJob as JTrainJob                    # noqa: E402
from repro.configs import get_arch                             # noqa: E402
from repro.core import (PATTERNS as JPATTERNS,                 # noqa: E402
                        TimingModel as JTiming,
                        heterogeneous_speeds as j_speeds,
                        make_scheduler as j_make_scheduler)
from repro.distributed import AsyncConfig as JAsyncConfig      # noqa: E402
from repro.distributed import AsyncTrainer as JTrainer         # noqa: E402
from repro.faults import GuardConfig as JGuardConfig           # noqa: E402
from repro.models import model as JM                           # noqa: E402
from repro.optim import OptConfig as JOptConfig                # noqa: E402
from repro.runtime import RunPlan as JRunPlan                  # noqa: E402
from repro.runtime import compile_plan as j_compile_plan       # noqa: E402
from repro.runtime import make_batch_fn as j_make_batch_fn     # noqa: E402
from repro.scenarios import parse_scenario as j_parse          # noqa: E402
from repro.scenarios import realise_world as j_realise         # noqa: E402
from repro.scenarios import tau_report as j_tau_report         # noqa: E402
from repro_torch.api import ExperimentSpec, TrainerBackend, TrainJob  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch         # noqa: E402
from repro_torch.core import (TimingModel, heterogeneous_speeds,  # noqa: E402
                              make_scheduler)
from repro_torch.distributed import AsyncConfig, AsyncTrainer  # noqa: E402
from repro_torch.distributed.async_trainer import (            # noqa: E402
    quantile_index, sparsify)
from repro_torch.faults import GuardConfig                     # noqa: E402
from repro_torch.models import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.optim import OptConfig                        # noqa: E402
from repro_torch.runtime import METRICS, RunPlan, compile_plan  # noqa: E402
from repro_torch.scenarios import parse_scenario, realise_world  # noqa: E402
from repro_torch.scenarios import tau_report                   # noqa: E402
from repro_torch.tree import tree_leaves                       # noqa: E402
from torch_parity import port_params, tree_f32                 # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
GROUPS, B, S = 2, 4, 16

#: one world per channel, and all four together
CHANNELS = {"availability": "elastic:k=1,every=4,span=2",
            "zipf_as": "data_drift:a0=1.2,a1=2.0",
            "grad_density": "sparsify:frac=0.5",
            "fault_gain": "nan_grad:k=2,every=4,span=1;"
                          "corrupt_receipt:k=1,scale=1e4,every=6,span=1"}
ALL = ";".join(CHANNELS.values())
PLAN_FIELDS = ("masks", "delay_scales", "token_cdf", "group_perms",
               "cdf_bank", "cdf_index", "grad_density", "fault_gain")


def _job_kw(**kw):
    return dict(dict(global_batch=8, seq_len=16,
                     arch_overrides=(("vocab", 97),)), **kw)


def _spec_pair(scenario, T=12, **job_kw):
    base = dict(scheduler="shuffled", timing="poisson:slow=6", T=T,
                n_workers=4, seed=0, scenario=scenario)
    return (ExperimentSpec(objective=TrainJob(**_job_kw(**job_kw)), **base),
            JSpec(objective=JTrainJob(**_job_kw(**job_kw)), **base))


def _assert_plans_equal(tp, jp):
    for f in PLAN_FIELDS:
        got, want = getattr(tp, f), getattr(jp, f)
        if want is None:
            assert got is None, f
            continue
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tp.summary() == jp.summary()


# ---------------------------------------------------------------------------
# the plan's channels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("channel", list(CHANNELS) + ["all"])
def test_compile_plan_channels_match_jax(channel):
    tspec, jspec = _spec_pair(ALL if channel == "all" else CHANNELS[channel])
    tw = TrainerBackend.world_for(tspec, 4)
    jw = JBackend.world_for(jspec, 4)
    names = list(CHANNELS) if channel == "all" else [channel]
    for name in names:
        np.testing.assert_array_equal(getattr(tw, name), getattr(jw, name))
    tp = compile_plan(tw.schedule, tspec.objective, rounds=12, n_groups=4,
                      seed=0, **{n: getattr(tw, n) for n in names})
    jp = j_compile_plan(jw.schedule, jspec.objective, rounds=12, n_groups=4,
                        seed=0, **{n: getattr(jw, n) for n in names})
    _assert_plans_equal(tp, jp)
    s = tp.summary()
    assert s["sparsified"] == ("grad_density" in names)
    assert s["faulted"] == ("fault_gain" in names)
    assert (s["n_cdf_phases"] >= 2) == ("zipf_as" in names)
    if "availability" in names:
        assert (tw.availability[:12] == 0).any()
        assert np.all(tp.masks[tw.availability[:12] == 0] == 0.0)
    # channels shorter than the plan pad with their neutral values
    short = {n: getattr(tw, n)[:5] for n in names}
    _assert_plans_equal(
        compile_plan(tw.schedule, tspec.objective, rounds=12, n_groups=4,
                     **short),
        j_compile_plan(jw.schedule, jspec.objective, rounds=12, n_groups=4,
                       **{n: getattr(jw, n)[:5] for n in names}))


def _bad_channels(R, n):
    bank = np.tile(np.linspace(0.1, 1.0, 97, dtype=np.float32), (2, 1))
    return {
        "index_alone": dict(cdf_index=np.zeros(R, np.int32)),
        "bank_shape": dict(cdf_bank=np.ones((2, 5), np.float32),
                           cdf_index=np.zeros(R, np.int32)),
        "index_shape": dict(cdf_bank=bank,
                            cdf_index=np.zeros(R - 1, np.int32)),
        "index_range": dict(cdf_bank=bank,
                            cdf_index=np.full(R, 99, np.int32)),
        "density_shape": dict(grad_density=np.ones(R - 1, np.float32)),
        "density_zero": dict(grad_density=np.zeros(R, np.float32)),
        "density_above_one": dict(grad_density=np.full(R, 1.5, np.float32)),
        "gain_shape": dict(fault_gain=np.ones((R, n + 1), np.float32)),
        "gain_zero": dict(fault_gain=np.zeros((R, n), np.float32)),
    }


@pytest.mark.parametrize("case", list(_bad_channels(4, 4)))
def test_run_plan_validation_matches_jax(case):
    tspec, jspec = _spec_pair(None, T=4)
    _, ts = TrainerBackend.masks_for(tspec, 4)
    _, js = JBackend.masks_for(jspec, 4)
    tp = compile_plan(ts, tspec.objective, rounds=4, n_groups=4)
    jp = j_compile_plan(js, jspec.objective, rounds=4, n_groups=4)
    bad = _bad_channels(4, 4)[case]
    errors = []
    for plan, cls in ((tp, RunPlan), (jp, JRunPlan)):
        common = {f.name: getattr(plan, f.name)
                  for f in dataclasses.fields(cls)
                  if f.name in ("masks", "delay_scales", "data_keys",
                                "token_cdf", "group_perms", "global_batch",
                                "seq_len", "seed")}
        with pytest.raises(ValueError) as err:
            cls(**common, **bad)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("kw", [
    dict(availability=np.ones((4, 3), np.float32)),
    dict(fault_gain=np.ones((4, 3), np.float32)),
    dict(zipf_as=np.full(4, -1.0)),
], ids=["availability_width", "gain_width", "zipf_sign"])
def test_compile_plan_channel_errors_match_jax(kw):
    tspec, jspec = _spec_pair(None, T=4)
    _, ts = TrainerBackend.masks_for(tspec, 4)
    _, js = JBackend.masks_for(jspec, 4)
    with pytest.raises(ValueError) as got:
        compile_plan(ts, tspec.objective, rounds=4, n_groups=4, **kw)
    with pytest.raises(ValueError) as want:
        j_compile_plan(js, jspec.objective, rounds=4, n_groups=4, **kw)
    assert str(got.value) == str(want.value)


#: the golden scenario suite's worlds (tests/test_scenarios_golden.py:31-47)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures",
                          "scenarios")
GOLDEN_WORLDS = {"straggler": "straggler:k=2,factor=8,every=3,span=2",
                 "elastic": "elastic:k=1,every=3,span=2"}
GOLDEN = [(w, p) for w in sorted(GOLDEN_WORLDS) for p in JPATTERNS]


@pytest.mark.parametrize("world,pattern", GOLDEN,
                         ids=[f"{w}-{p}" for w, p in GOLDEN])
def test_golden_worlds_through_the_plan(world, pattern):
    """Each golden world (5 workers, fedbuff b=2, T = 24) realised by the
    port, checked against its fixture, and lowered into a plan by both
    packages: array-equal, with every down (round, worker) zeroed."""
    with open(os.path.join(GOLDEN_DIR, f"{world}_{pattern}.json")) as f:
        gold = json.load(f)
    n, T, seed = 5, 24, 0

    def build(realise, parse, make, timing, speeds):
        return realise(parse(GOLDEN_WORLDS[world]),
                       make("fedbuff", n, b=2, seed=seed),
                       timing(speeds(n, slow_factor=4.0), pattern,
                              seed=seed), T, seed=seed)

    tw = build(realise_world, parse_scenario, make_scheduler, TimingModel,
               heterogeneous_speeds)
    jw = build(j_realise, j_parse, j_make_scheduler, JTiming, j_speeds)
    for f in ("workers", "assign_iters", "unfinished_assign_iters"):
        assert [int(x) for x in getattr(tw.schedule, f)] == gold[f], f
    want_avail = gold["availability"]
    assert (tw.availability is None) == (want_avail is None)
    job = dict(global_batch=10, seq_len=8, arch_overrides=(("vocab", 97),))
    kw = {} if tw.availability is None else \
        {"availability": tw.availability}
    tp = compile_plan(tw.schedule, TrainJob(**job), n_groups=n, **kw)
    jp = j_compile_plan(jw.schedule, JTrainJob(**job), n_groups=n,
                        **({} if jw.availability is None else
                           {"availability": jw.availability}))
    _assert_plans_equal(tp, jp)
    if want_avail is not None:
        avail = np.asarray(want_avail)[:tp.rounds]
        assert np.all(tp.masks[:avail.shape[0]][avail == 0] == 0.0)


def test_tau_report_of_a_faulted_world_matches_jax():
    tspec, jspec = _spec_pair(ALL, T=16)
    tw = TrainerBackend.world_for(tspec, 4)
    jw = JBackend.world_for(jspec, 4)
    got = tau_report(tw.schedule, "shuffled", concurrency=4,
                     scenario_spec=ALL)
    want = j_tau_report(jw.schedule, "shuffled", concurrency=4,
                        scenario_spec=ALL)
    assert got["global"] == want["global"]
    assert got["koloskova"] == want["koloskova"]
    assert [dataclasses.asdict(w) for w in got["windows"]] == \
        [dataclasses.asdict(w) for w in want["windows"]]


# ---------------------------------------------------------------------------
# the sparsifier
# ---------------------------------------------------------------------------
@jax.jit
def _j_sparsify(g, dens):
    """The JAX step's sparsifier (src/repro/distributed/async_trainer.py,
    ``sparsify``), on one leaf at a traced density."""
    dens = jnp.clip(jnp.asarray(dens, jnp.float32), 0.0, 1.0)
    a = jnp.abs(g.astype(jnp.float32)).reshape(-1)
    thr = jnp.quantile(a, 1.0 - dens)
    keep = jnp.abs(g.astype(jnp.float32)) >= thr
    return g * keep.astype(g.dtype), thr


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n,dtype,density", [
    (2 ** 24 + 3, "bfloat16", 1 / 3), (2 ** 24 + 3, "float32", 0.5),
    (1000, "bfloat16", 0.1), (1000, "float32", 1.0), (7, "float32", 0.3)])
def test_sparsify_is_bit_identical_to_jax(n, dtype, density):
    g = np.random.default_rng(n % 97).standard_normal(n).astype(np.float32)
    jg = jnp.asarray(g).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    want, thr = _j_sparsify(jg, np.float32(density))
    tg = _t(np.asarray(jg.astype(jnp.float32))).to(getattr(torch, dtype))
    got = sparsify(tg, np.float32(density))
    assert got.dtype == tg.dtype
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":                         # bits: -0 is not +0
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    else:                                           # XLA selects on f32
        np.testing.assert_array_equal(got, want)
    if density == 1.0:
        np.testing.assert_array_equal(got, tg.numpy())  # identity
    if dtype == "float32":          # bf16 ties at the threshold keep more
        kept = int((got != 0).sum())
        assert abs(kept - density * n) <= 2 + 1e-6 * n


def test_sparsify_propagates_nan_as_jax_does():
    """A NaN makes the threshold NaN, so nothing finite is kept and the
    NaN stays (bf16, where both packages multiply)."""
    g = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    g[5] = np.nan
    jg = jnp.asarray(g).astype(jnp.bfloat16)
    want, thr = _j_sparsify(jg, np.float32(0.5))
    got = sparsify(_t(np.asarray(jg.astype(jnp.float32))).bfloat16(), 0.5)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    finite = ~np.isnan(want)                        # NaN payloads differ
    np.testing.assert_array_equal(np.isnan(got), ~finite)
    np.testing.assert_array_equal(got[finite].view(np.int32),
                                  want[finite].view(np.int32))
    assert np.isnan(float(thr)) and np.isnan(got[5])
    assert (got[np.arange(64) != 5] == 0).all()


def _j_quantile_index(n, dens):
    """``jnp.quantile``'s index arithmetic for an n-element axis (method
    linear), op for op as ``jax._src.numpy.reductions._quantile`` writes
    it, at a traced density."""
    q = 1.0 - jnp.clip(jnp.asarray(dens, jnp.float32), 0.0, 1.0)
    nf = lax.convert_element_type(n, jnp.float32)
    q = lax.mul(q, nf - 1)
    low, high = lax.floor(q), lax.ceil(q)
    hw = lax.sub(q, low)
    lw = lax.sub(jnp.float32(1), hw)
    low = lax.clamp(jnp.float32(0), low, nf - 1)
    high = lax.clamp(jnp.float32(0), high, nf - 1)
    return (lax.convert_element_type(low, jnp.int32),
            lax.convert_element_type(high, jnp.int32), lw, hw)


@pytest.mark.parametrize("density", [0.5, 0.1, 1 / 3, 1.0, 0.999])
@pytest.mark.parametrize("n", [151936 * 896, 24 * 896 * 4864, 2 ** 24 + 3])
def test_quantile_index_matches_jax_f32(n, density):
    """qwen2-0.5b's embedding (151936 × 896) and stacked MLP leaf: n − 1
    is not exact in f32 there, and the port repeats JAX's rounding."""
    got = quantile_index(n, np.float32(density))
    want = jax.jit(_j_quantile_index, static_argnums=0)(n,
                                                         np.float32(density))
    assert got[:2] == (int(want[0]), int(want[1]))
    assert np.float32(got[2]).tobytes() == np.asarray(want[2]).tobytes()
    assert np.float32(got[3]).tobytes() == np.asarray(want[3]).tobytes()
    if density == 0.5 and n == 151936 * 896:
        # the f64 position differs from the f32 one JAX uses
        assert got[0] != int(np.floor(0.5 * (n - 1)))


# ---------------------------------------------------------------------------
# the train step with each channel, against the JAX step
# ---------------------------------------------------------------------------
MASKS = np.asarray([[1, 1], [1, 0], [1, 1], [0, 1], [1, 1]], np.float32)
#: per round: (fault gains, keep-density); None is the neutral value
CHANNEL_ROUNDS = [
    (None, None),
    (np.asarray([1.0, 3.5], np.float32), None),      # corrupted receipt
    (np.asarray([0.25, 1.0], np.float32), None),
    (np.asarray([np.nan, 2.0], np.float32), None),    # a non-participant's
    (np.asarray([0.5, 1.5], np.float32), None),       # NaN is masked out
]
POISON_ROUNDS = [
    (None, None),
    (np.asarray([np.nan, 1.0], np.float32), None),    # skipped
    (np.asarray([2.0, 1.0], np.float32), None),
    (np.asarray([1.0, np.nan], np.float32), None),    # skipped
    (None, None),
]


def _cfgs(dtype):
    over = dict(remat="none", dtype=dtype)
    return (get_arch("qwen2-0.5b").reduced().with_(**over),
            t_get_arch("qwen2-0.5b").reduced().with_(**over))


def _pair(dtype, impl, guards):
    """(jitted JAX step, state), (port step, state) from one JAX init."""
    jcfg, tcfg = _cfgs(dtype)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jt = JTrainer(jcfg, mesh, opt=JOptConfig(lr=1e-2,
                                             update_impl="reference"),
                  async_cfg=JAsyncConfig(
                      delay_rounds=1,
                      guards=JGuardConfig() if guards else None))
    jt.n_groups = GROUPS
    js = jt.init_state(jax.random.PRNGKey(0))
    if dtype == "float32":
        js = dict(js, params=tree_f32(js["params"]),
                  gbuf=tree_f32(js["gbuf"]))
    tt = AsyncTrainer(tcfg, opt=OptConfig(lr=1e-2, update_impl=impl),
                      async_cfg=AsyncConfig(
                          delay_rounds=1,
                          guards=GuardConfig() if guards else None),
                      device="cpu")
    tt.n_groups = GROUPS
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    return (_j_step(jt), js), (tt.train_step_fn(), ts)


def _j_step(jt):
    """The JAX step jitted once with every channel as an argument (a
    neutral gain of ones and density 1 are exact no-ops)."""
    step = jt.train_step_fn()
    return jax.jit(lambda s, b, m, sc, d, g: step(
        s, b, m, delay_scale=sc, grad_density=d, fault_gain=g))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _assert_state(ts, js, dtype):
    """Integer leaves and the health as JAX has them; f32 float leaves to
    a 1e-4 relative L2 error (the Adam k bias 1e-2), bf16 ones finite."""
    got = state_to_numpy(ts)
    for path, want in jax.tree_util.tree_leaves_with_path(js):
        keys = tuple(k.key for k in path)
        node = got
        for key in keys:
            node = node[key]
        want = np.asarray(want)
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(node, want, err_msg=str(keys))
            continue
        if want.dtype.name == "bfloat16":
            node = node.view(jnp.bfloat16)
        node, want = node.astype(np.float32), want.astype(np.float32)
        if keys == ("guard", "health"):
            np.testing.assert_allclose(node, want, rtol=1e-6)
        elif dtype == "bfloat16":
            assert np.isfinite(node).all(), keys
        else:
            loose = keys == ("params", "blocks", "attn", "bk")
            assert _rel_l2(node, want) < (1e-2 if loose else 1e-4), keys


def _drive(jstep, js, tstep, ts, rounds, dtype, seed):
    """Rounds of (gain, density) through both steps; returns the metric
    rows of each."""
    jrows, trows = [], []
    for q, (gain, dens) in enumerate(rounds):
        tok = np.random.default_rng(seed + q).integers(
            0, 512, (B, S)).astype(np.int32)
        mask = MASKS[q]
        js, jm = jstep(js, {"tokens": jnp.asarray(tok)}, jnp.asarray(mask),
                       jnp.float32(1.0),
                       jnp.float32(1.0 if dens is None else dens),
                       jnp.asarray(np.ones(GROUPS, np.float32)
                                   if gain is None else gain))
        kw = {}
        if dens is not None:
            kw["grad_density"] = np.float32(dens)
        if gain is not None:
            kw["fault_gain"] = torch.from_numpy(gain)
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(tok)},
                       torch.from_numpy(mask), **kw)
        jrows.append({k: float(jm[k]) for k in METRICS})
        trows.append({k: tm[k].item() for k in METRICS})
    return js, ts, jrows, trows


def _assert_rows(trows, jrows, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for q, (t, j) in enumerate(zip(trows, jrows)):
        assert t["skipped"] == j["skipped"], f"round {q}"
        np.testing.assert_allclose(t["gscale"], j["gscale"], rtol=1e-6,
                                   err_msg=f"round {q}")
        for k in ("loss", "ce", "grad_norm", "participation"):
            np.testing.assert_allclose(t[k], j[k], err_msg=f"round {q} {k}",
                                       **tol)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_channels_match_jax(dtype, impl):
    """Fault gains (corrupted receipts, a masked-out NaN) through an
    unguarded step on both routes: the metrics and the state after five
    rounds against the JAX step."""
    (jstep, js), (tstep, ts) = _pair(dtype, impl, guards=False)
    js, ts, jrows, trows = _drive(jstep, js, tstep, ts, CHANNEL_ROUNDS,
                                  dtype, seed=40)
    _assert_rows(trows, jrows, dtype)
    assert all(np.isfinite(r["loss"]) for r in trows)
    _assert_state(ts, js, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparsified_step_matches_jax(dtype):
    """Densities 0.3, then 0.5 with a gain: the buffered (sparsified) grads
    of each round against the JAX step's: kept sets equal but for entries
    within rounding of the threshold, kept values to the grads' tolerance,
    and the loss to the step's."""
    (jstep, js), (tstep, ts) = _pair(dtype, "pallas", guards=False)
    flips = 1e-3 if dtype == "float32" else 1e-2
    for q, (gain, dens) in enumerate([(None, 0.3),
                                      (np.asarray([1.5, 1.0], np.float32),
                                       0.5)]):
        js, ts, jrows, trows = _drive(jstep, js, tstep, ts, [(gain, dens)],
                                      dtype, seed=90 + q)
        _assert_rows(trows, jrows, dtype)
        got = state_to_numpy(ts)["gbuf"]
        for path, want in jax.tree_util.tree_leaves_with_path(js["gbuf"]):
            node = got
            for k in path:
                node = node[k.key]
            want = np.asarray(want)
            if want.dtype.name == "bfloat16":
                node = node.view(jnp.bfloat16)
            a, b = node.astype(np.float32), want.astype(np.float32)
            both = (a != 0) & (b != 0)
            assert abs((a != 0).mean() - dens) <= flips + 1e-2, path
            if dtype == "bfloat16" and path[-1].key == "bk":
                # the k bias's gradient is nearly cancelled by the softmax
                # (tests/test_torch_trainer.py), so in bf16 its entries
                # near the threshold are rounding noise: only the kept
                # fraction is held
                continue
            assert ((a != 0) != (b != 0)).mean() <= flips, path
            bound = 3e-2 if dtype == "bfloat16" else 1e-4
            assert _rel_l2(a[both], b[both]) < bound, path


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guarded_step_matches_jax(dtype, impl):
    """Guards on, two poisoned rounds among clean ones: the skips, the
    health scale and the state against the JAX step."""
    (jstep, js), (tstep, ts) = _pair(dtype, impl, guards=True)
    js, ts, jrows, trows = _drive(jstep, js, tstep, ts, POISON_ROUNDS,
                                  dtype, seed=60)
    assert [r["skipped"] for r in trows] == [0, 1, 0, 1, 0]
    assert [r["grad_norm"] for r in trows][1] == 0.0
    _assert_rows(trows, jrows, dtype)
    _assert_state(ts, js, dtype)
    assert int(ts["opt"]["count"]) == 3 and int(ts["step"]) == 5


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_guarded_skip_keeps_every_leaf_bit_for_bit(impl):
    """A poisoned round on a guarded trainer: params, moments, count and
    the delay buffer keep their bits (the stale buffer is not replaced by
    the NaN grads), the step advances and the health backs off as JAX's
    does."""
    (jstep, js), (tstep, ts) = _pair("bfloat16", impl, guards=True)
    js, ts, _, _ = _drive(jstep, js, tstep, ts, POISON_ROUNDS[:1],
                          "bfloat16", seed=80)
    kept = ("params", "opt", "gbuf")
    old = {k: [t.clone() for t in tree_leaves(ts[k])] for k in kept}
    js, ts, jrows, trows = _drive(jstep, js, tstep, ts, POISON_ROUNDS[1:2],
                                  "bfloat16", seed=81)
    assert trows[0]["skipped"] == jrows[0]["skipped"] == 1.0
    assert trows[0]["grad_norm"] == 0.0
    for k in kept:
        new = tree_leaves(ts[k])
        assert len(new) == len(old[k])
        for a, b in zip(new, old[k]):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), k
    np.testing.assert_allclose(ts["guard"]["health"].numpy(),
                               np.asarray(js["guard"]["health"]), rtol=1e-6)
    assert ts["guard"]["health"].tolist() == [0.5, 0.5]
    assert int(ts["opt"]["count"]) == int(js["opt"]["count"]) == 1
    assert int(ts["step"]) == int(js["step"]) == 2


def _bits(t):
    """A tensor's bits as integers (NaN compares equal to itself)."""
    return {torch.bfloat16: lambda: t.view(torch.int16),
            torch.float32: lambda: t.view(torch.int32)}.get(
                t.dtype, lambda: t)()


# ---------------------------------------------------------------------------
# the executor and the backend with every channel on
# ---------------------------------------------------------------------------
def _port_run(spec, runtime, guards=True, impl="pallas", **kw):
    job = dataclasses.replace(spec.objective, guards=guards,
                              update_impl=impl)
    return TrainerBackend("cpu", runtime=runtime, **kw).run(
        dataclasses.replace(spec, objective=job))


def test_scan_equals_eager_with_every_channel():
    tspec, _ = _spec_pair(ALL, T=12, arch_overrides=(("n_layers", 1),
                                                      ("vocab", 97)))
    scan = _port_run(dataclasses.replace(tspec, rounds_per_launch=5),
                     "scan")
    eager = _port_run(tspec, "eager")
    for k in METRICS:
        np.testing.assert_array_equal(
            np.asarray([r[k] for r in scan.extra["metrics"]]),
            np.asarray([r[k] for r in eager.extra["metrics"]]), err_msg=k)
    for a, b in zip(tree_leaves(scan.x), tree_leaves(eager.x)):
        assert torch.equal(a, b)
    assert scan.extra["launches"] == 3 and eager.extra["launches"] == 12
    plan = compile_plan(scan.schedule, tspec.objective, rounds=12,
                        n_groups=4, seed=0,
                        **{n: getattr(TrainerBackend.world_for(tspec, 4), n)
                           for n in CHANNELS})
    poisoned = (np.isnan(plan.fault_gain) & (plan.masks > 0)).any(axis=1)
    skipped = np.asarray([r["skipped"] for r in scan.extra["metrics"]])
    np.testing.assert_array_equal(skipped, poisoned.astype(np.float32))
    assert poisoned.any()
    assert scan.extra["plan_summary"] == plan.summary()
    assert scan.extra["scenario"] == ALL
    assert all(torch.isfinite(t).all() for t in tree_leaves(scan.x)
               if t.is_floating_point())


def test_unguarded_poisoned_run_goes_non_finite():
    tspec, _ = _spec_pair(CHANNELS["fault_gain"], T=12,
                          arch_overrides=(("n_layers", 1), ("vocab", 97)))
    res = _port_run(tspec, "scan", guards=False)
    assert not all(torch.isfinite(t).all()
                   for t in tree_leaves(res.x["params"]))
    assert [r["skipped"] for r in res.extra["metrics"]] == [0.0] * 12


def _jax_inputs(jspec):
    """The JAX run's initial params and its per-round batches, drawn from
    the scenario plan's keys and data-drift phases."""
    job = jspec.objective
    cfg = job.make_arch()
    params = JM.init_params(cfg, jax.random.PRNGKey(jspec.seed))
    world = JBackend.world_for(jspec, jspec.n_workers)
    plan = j_compile_plan(world.schedule, job, rounds=jspec.T,
                          n_groups=jspec.n_workers, seed=jspec.seed,
                          availability=world.availability,
                          zipf_as=world.zipf_as,
                          grad_density=world.grad_density,
                          fault_gain=world.fault_gain)
    batch_of = jax.jit(j_make_batch_fn(plan, cfg))
    batches = [np.asarray(batch_of(jnp.asarray(k), jnp.int32(c))["tokens"])
               for k, c in zip(plan.data_keys, plan.cdf_index)]
    return params, batches


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_backend_curve_with_scenario_and_guards_matches_jax(impl):
    """``TrainJob(guards=True)`` under the four-channel world through the
    JAX backend and the port's, the port on the JAX run's params and
    batches: the loss curve within rtol 5e-3 (the trainer-curve tolerance
    of ``tests/test_optim_fused.py:285-286``; a skipped round's loss is
    NaN in both), the skips and health scales exact."""
    base = dict(scheduler="shuffled", timing="poisson:slow=6", T=12,
                n_workers=4, seed=0, scenario=ALL, stepsize=3e-3,
                runtime="eager")
    job = dict(global_batch=8, seq_len=16, guards=True)
    jspec = JSpec(objective=JTrainJob(**job), **base)
    want = JBackend(runtime="eager").run(jspec)
    params, batches = _jax_inputs(jspec)
    spec = ExperimentSpec(objective=TrainJob(update_impl=impl, **job), **base)
    got = TrainerBackend("cpu", params_fn=lambda c, d: port_params(params),
                         batch_fn=lambda q: {"tokens": batches[q]}).run(spec)
    np.testing.assert_allclose(got.losses, want.losses, rtol=5e-3)
    for k in ("skipped", "gscale"):
        np.testing.assert_array_equal([r[k] for r in got.extra["metrics"]],
                                      [r[k] for r in want.extra["metrics"]])
    assert any(r["skipped"] for r in got.extra["metrics"])
    np.testing.assert_array_equal(got.extra["masks"], want.extra["masks"])
    assert got.extra["plan_summary"] == want.extra["plan_summary"]
    assert got.extra["scenario"] == want.extra["scenario"] == ALL
