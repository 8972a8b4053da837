"""`repro_torch.core`, `.data` and `.runtime.plan` against the JAX package.

The engine, schedulers and timing models are verbatim numpy copies, so the
port must realise the same schedules bit for bit: the 35 golden engine
fixtures replay through it, and the round lowering (masks, lowered rounds,
delay scales) and the plan's tables are array-equal to the JAX package's on
the same schedules.  The plan's data keys are the port's own and are only
checked for shape and purity.
"""
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import core as J                                    # noqa: E402
from repro.api import ExperimentSpec as JSpec                  # noqa: E402
from repro.api import TrainJob as JTrainJob                    # noqa: E402
from repro.api import TrainerBackend as JBackend               # noqa: E402
from repro.runtime import compile_plan as j_compile_plan       # noqa: E402
from repro_torch import core as T                              # noqa: E402
from repro_torch.api import ExperimentSpec, TrainJob           # noqa: E402
from repro_torch.api import TrainerBackend                     # noqa: E402
from repro_torch.core.trace import summarize                   # noqa: E402
from repro_torch.runtime import compile_plan, round_keys       # noqa: E402

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "engine")
#: the fixture scenario of tests/test_engine_golden.py
N_WORKERS, T_FIX, SEED, SLOW = 5, 24, 0, 4.0
WAITING = {"pure_waiting": 3, "fedbuff": 3, "minibatch": 3}
PAIRS = [(s, p) for s in sorted(T.REGISTRY) for p in T.PATTERNS]


def _port_schedule(name, pattern, core=T):
    sched = core.make_scheduler(name, N_WORKERS, b=WAITING.get(name, 1),
                                seed=SEED)
    timing = core.TimingModel(core.heterogeneous_speeds(
        N_WORKERS, slow_factor=SLOW), pattern, seed=SEED)
    return core.build_schedule(sched, timing, T_FIX)


def test_registries_match():
    assert sorted(T.REGISTRY) == sorted(J.REGISTRY)
    assert tuple(T.PATTERNS) == tuple(J.PATTERNS)
    assert len(PAIRS) == 35


@pytest.mark.parametrize("name,pattern", PAIRS,
                         ids=[f"{s}-{p}" for s, p in PAIRS])
def test_engine_fixture_replays_bitwise(name, pattern):
    with open(os.path.join(FIXTURE_DIR, f"{name}_{pattern}.json")) as f:
        want = json.load(f)
    s = _port_schedule(name, pattern)
    np.testing.assert_array_equal(s.workers, want["workers"])
    np.testing.assert_array_equal(s.assign_iters, want["assign_iters"])
    np.testing.assert_array_equal(s.unfinished_assign_iters,
                                  want["unfinished_assign_iters"])
    assert s.tau_max() == want["tau_max"]
    assert s.tau_avg() == want["tau_avg"]
    assert s.tau_c() == want["tau_c"]
    assert s.wait_b == want["wait_b"]


@pytest.mark.parametrize("name", ["pure", "fedbuff", "shuffled", "random"])
@pytest.mark.parametrize("delay_rounds,adaptive", [(0, False), (1, False),
                                                   (1, True), (2, True)])
def test_round_lowering_matches_jax(name, delay_rounds, adaptive):
    ts, js = (_port_schedule(name, "poisson", core=c) for c in (T, J))
    np.testing.assert_array_equal(T.round_masks(ts), J.round_masks(js))
    np.testing.assert_array_equal(T.round_masks(ts, 3), J.round_masks(js, 3))
    for got, want in zip(
            T.lower_rounds(ts, 5, delay_rounds=delay_rounds,
                           adaptive=adaptive),
            J.lower_rounds(js, 5, delay_rounds=delay_rounds,
                           adaptive=adaptive)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        T.round_delay_scales(ts, delay_rounds=delay_rounds),
        J.round_delay_scales(js, delay_rounds=delay_rounds))
    assert summarize(ts) == J.trace.summarize(js)


def _specs(scheduler, **job):
    kw = dict(scheduler=scheduler, timing="poisson:slow=4", n_workers=4,
              T=6, seed=3)
    return (ExperimentSpec(objective=TrainJob(**job), **kw),
            JSpec(objective=JTrainJob(**job), **kw))


@pytest.mark.parametrize("scheduler,adaptive", [
    ("pure", False), ("fedbuff:b=2", True), ("shuffled", True)])
def test_compile_plan_matches_jax(scheduler, adaptive):
    job = dict(global_batch=8, seq_len=16, heterogeneity=0.5)
    tspec, jspec = _specs(scheduler, **job)
    tm, ts = TrainerBackend.masks_for(tspec, 4)
    jm, js = JBackend.masks_for(jspec, 4)
    np.testing.assert_array_equal(tm, jm)
    tp = compile_plan(ts, tspec.objective, rounds=5, n_groups=4, seed=3,
                      adaptive=adaptive)
    jp = j_compile_plan(js, jspec.objective, rounds=5, n_groups=4, seed=3,
                        adaptive=adaptive)
    for field in ("masks", "delay_scales", "token_cdf", "group_perms"):
        got, want = getattr(tp, field), getattr(jp, field)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert tp.summary() == jp.summary()
    assert tp.data_keys.shape == (5,) and tp.data_keys.dtype == np.uint64


def test_round_keys_are_a_pure_function_of_seed_and_round():
    a = round_keys(7, 6)
    np.testing.assert_array_equal(a[:4], round_keys(7, 4))
    assert len(set(a.tolist())) == 6
    assert not np.array_equal(a, round_keys(8, 6))


def test_plan_refuses_unported_channels():
    """The channels once refused here now lower as in the JAX package (the
    two plans are compared in ``test_torch_faults.py``): short channels pad
    with their neutral values, and a malformed one raises JAX's error."""
    tspec, jspec = _specs("pure", global_batch=8, seq_len=16)
    _, schedule = TrainerBackend.masks_for(tspec, 4)
    _, jschedule = JBackend.masks_for(jspec, 4)
    gain = np.ones((3, 4), np.float32)
    gain[1, 2] = np.nan
    kw = dict(zipf_as=np.asarray([1.2, 2.0, 1.6]), fault_gain=gain)
    tp = compile_plan(schedule, tspec.objective, **kw)
    jp = j_compile_plan(jschedule, jspec.objective, **kw)
    for f in ("cdf_bank", "cdf_index", "fault_gain", "masks"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    assert tp.summary() == jp.summary()
    assert tp.summary()["faulted"] and tp.summary()["n_cdf_phases"] == 3
    assert (tp.cdf_index[3:] == tp.cdf_index[2]).all()     # last exponent
    assert (tp.fault_gain[3:] == 1.0).all()                # neutral gain
    with pytest.raises(ValueError, match="fault_gain must be"):
        compile_plan(schedule, tspec.objective, fault_gain=np.ones((3, 3)))


def test_spec_validates_scheduler_as_jax_does():
    with pytest.raises(ValueError, match="unknown scheduler"):
        ExperimentSpec(scheduler="nope")
    with pytest.raises(ValueError, match="unknown scheduler"):
        JSpec(scheduler="nope")
    spec = ExperimentSpec(scheduler="fedbuff:b=3", n_workers=5, T=4)
    assert spec.make_scheduler().wait_b == 3
    # a scenario realises its schedule through the world's wrap, as JAX's
    # spec does (it raised before the scenario worlds were ported)
    kw = dict(scenario="straggler:k=1,factor=8,every=2,span=1", n_workers=2,
              T=16)
    got, want = ExperimentSpec(**kw).build_schedule(), JSpec(**kw).build_schedule()
    np.testing.assert_array_equal(got.workers, want.workers)
    np.testing.assert_array_equal(got.assign_iters, want.assign_iters)
    with pytest.raises(ValueError, match="unknown transform"):
        ExperimentSpec(scenario="warp:x=1", n_workers=2)
