"""The port's scenario worlds and fault grammar, held to the JAX package.

``repro_torch.scenarios`` and ``repro_torch.faults`` are verbatim copies
(numpy and pure Python).  The 10 golden fixtures of
``tests/fixtures/scenarios/`` are replayed through the port bit for bit
with the record of ``tests/test_scenarios_golden.py:59-75``; the identity
scenario is the stationary world bit for bit; grammar errors are
``ValueError``s; the τ-report equals the JAX package's.  The trainer and
serve backends refuse a scenario until its ``RunPlan`` channels are ported.
"""
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi                                     # noqa: E402
import repro.faults as jfaults                               # noqa: E402
import repro.scenarios as jscen                              # noqa: E402

from repro_torch import api, faults, scenarios               # noqa: E402
from repro_torch.runtime import compile_plan                  # noqa: E402
from repro_torch.core import (PATTERNS, TimingModel,         # noqa: E402
                              build_schedule, heterogeneous_speeds,
                              make_scheduler)
from repro_torch.objectives import (LogRegProblem,           # noqa: E402
                                    make_synthetic)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures",
                           "scenarios")
#: the golden suite's world (tests/test_scenarios_golden.py:31-40)
N_WORKERS, T, SEED, SLOW, WAIT_B = 5, 24, 0, 4.0, 2
WORLDS = {"straggler": "straggler:k=2,factor=8,every=3,span=2",
          "elastic": "elastic:k=1,every=3,span=2"}
CASES = [(w, p) for w in sorted(WORLDS) for p in PATTERNS]


def _pair(pattern="poisson", scheduler="fedbuff", b=WAIT_B, n=N_WORKERS,
          slow=SLOW, seed=SEED):
    return (make_scheduler(scheduler, n, b=b, seed=seed),
            TimingModel(heterogeneous_speeds(n, slow_factor=slow), pattern,
                        seed=seed))


def _record(w) -> dict:
    s = w.schedule
    return {
        "workers": [int(x) for x in s.workers],
        "assign_iters": [int(x) for x in s.assign_iters],
        "unfinished_assign_iters": [int(x)
                                    for x in s.unfinished_assign_iters],
        "tau_max": s.tau_max(),
        "tau_avg": s.tau_avg(),
        "tau_c": s.tau_c(),
        "wait_b": s.wait_b,
        "rounds": w.rounds,
        "availability": (None if w.availability is None
                         else [[int(v) for v in row]
                               for row in w.availability]),
    }


@pytest.mark.parametrize("world,pattern", CASES,
                         ids=[f"{w}-{p}" for w, p in CASES])
def test_world_matches_golden_fixture(world, pattern):
    with open(os.path.join(FIXTURE_DIR, f"{world}_{pattern}.json")) as f:
        want = json.load(f)
    got = _record(scenarios.realise_world(
        scenarios.parse_scenario(WORLDS[world]), *_pair(pattern), T,
        seed=SEED))
    want.pop("_scenario")
    assert got == want


@pytest.mark.parametrize("pattern", PATTERNS)
def test_identity_world_is_bit_for_bit_stationary(pattern):
    base = build_schedule(*_pair(pattern), T)
    for spec in ("", "identity", "identity;identity"):
        world = scenarios.realise_world(scenarios.parse_scenario(spec),
                                        *_pair(pattern), T, seed=12345)
        s = world.schedule
        for f in ("workers", "assign_iters", "finish_times"):
            np.testing.assert_array_equal(getattr(s, f), getattr(base, f))
        assert (s.tau_max(), s.tau_avg(), s.tau_c()) == \
            (base.tau_max(), base.tau_avg(), base.tau_c())
        assert world.availability is None and world.grad_density is None


def test_parse_errors_are_valueerrors():
    for spec, match in (("warp:x=1", "unknown transform"),
                        ("straggler:k", "malformed"),
                        ("straggler:zzz=3", "bad args"),
                        ("drift:amp=2.0", "amp")):
        with pytest.raises(ValueError, match=match):
            scenarios.parse_scenario(spec)
        with pytest.raises(ValueError):
            api.ExperimentSpec(n_workers=4, scenario=spec)


def test_fault_transforms_are_registered_like_jax():
    assert set(scenarios.TRANSFORMS) == set(jscen.TRANSFORMS)
    assert set(faults.FAULT_TRANSFORMS) == set(jfaults.FAULT_TRANSFORMS)
    for name, cls in scenarios.TRANSFORMS.items():
        assert cls.name == name
    spec = "nan_grad:k=1,every=3;worker_crash:k=1,at=2,span=2"
    assert scenarios.parse_scenario(spec).names == \
        jscen.parse_scenario(spec).names


def test_modules_are_verbatim_copies():
    for mine, theirs in ((scenarios.transforms, jscen.transforms),
                         (scenarios.scenario, jscen.scenario),
                         (scenarios.report, jscen.report),
                         (faults.guards, jfaults.guards),
                         (faults.transforms, jfaults.transforms)):
        assert inspect.getsource(mine) == inspect.getsource(theirs)


COMPOSITE = ("drift:amp=0.5,period=8;straggler:k=2,factor=6,every=4,span=2;"
             "elastic:k=1,every=5,span=2;data_drift:a0=1.0,a1=2.0;"
             "sparsify:frac=0.5")


def test_composite_world_matches_jax():
    got = scenarios.realise_world(scenarios.parse_scenario(COMPOSITE),
                                  *_pair("uniform"), 40, seed=3)
    from repro.core import (TimingModel as JTM, heterogeneous_speeds as jhs,
                            make_scheduler as jms)
    want = jscen.realise_world(
        jscen.parse_scenario(COMPOSITE),
        jms("fedbuff", N_WORKERS, b=WAIT_B, seed=SEED),
        JTM(jhs(N_WORKERS, slow_factor=SLOW), "uniform", seed=SEED), 40,
        seed=3)
    for f in ("workers", "assign_iters", "finish_times"):
        np.testing.assert_array_equal(getattr(got.schedule, f),
                                      getattr(want.schedule, f))
    for f in ("availability", "zipf_as", "grad_density"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.rounds == want.rounds


@pytest.mark.parametrize("policy", ["pure", "fedbuff", "shuffled"])
def test_tau_report_equals_jax(policy):
    sched, timing = _pair(scheduler=policy if policy != "pure" else "pure",
                          b=WAIT_B if policy == "fedbuff" else 1)
    s = build_schedule(sched, timing, 32)
    got = scenarios.tau_report(s, policy, concurrency=sched.concurrency(),
                               scenario_spec="straggler:k=1")
    want = jscen.tau_report(s, policy, concurrency=sched.concurrency(),
                            scenario_spec="straggler:k=1")
    assert got["global"] == want["global"]
    assert got["koloskova"] == want["koloskova"]
    assert [dataclasses.asdict(w) for w in got["windows"]] == \
        [dataclasses.asdict(w) for w in want["windows"]]
    assert scenarios.render_report(got) == jscen.render_report(want)


def _spec(**kw):
    base = dict(scheduler="fedbuff:b=2", timing="poisson:slow=4", T=16,
                n_workers=N_WORKERS)
    return {**base, **kw}


def test_spec_scenario_wrap_matches_jax():
    for scenario in (None, "", "straggler:k=1,factor=6,every=2,span=1",
                     "elastic:k=1,every=3,span=2"):
        got = api.ExperimentSpec(**_spec(scenario=scenario)).build_schedule()
        want = japi.ExperimentSpec(**_spec(scenario=scenario)).build_schedule()
        for f in ("workers", "assign_iters", "finish_times"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    spec = api.ExperimentSpec(**_spec(scenario="straggler:k=1,factor=6,"
                                                "every=2,span=1"))
    assert spec.make_scenario().names == ("straggler",)
    assert spec.build_world().rounds == 8
    assert api.ExperimentSpec(**_spec()).make_scenario().transforms == ()


def test_trainer_and_serve_backends_refuse_a_scenario():
    """Neither backend refuses a scenario any more.  The trainer realises
    the world and lowers its channels into the plan (an elastic world's
    down workers are dropped from the masks); the lock-step serve lane,
    like JAX's, reads none of it: the tokens are the clean serve's."""
    job = api.TrainJob(seq_len=16, arch_overrides=(("n_layers", 1),))
    train = api.ExperimentSpec(objective=job, n_workers=2, T=4,
                               scenario="straggler:k=1;elastic:k=1,every=2,"
                                        "span=1")
    res = api.run(train, device="cpu")
    assert res.extra["scenario"] == train.scenario
    assert np.isfinite(res.losses).all()
    world = api.TrainerBackend.world_for(train, 2)
    assert (world.availability[:4] == 0).any()
    plan = compile_plan(world.schedule, job, rounds=4, n_groups=2,
                        availability=world.availability)
    assert res.extra["plan_summary"] == plan.summary()
    assert (plan.masks[world.availability[:4] == 0] == 0).all()
    serve = api.ExperimentSpec(objective=api.ServeJob(), T=2)
    clean = api.ServeBackend(device="cpu").run(serve)
    for scenario in ("", "straggler:k=1", "nan_grad:k=1,every=1"):
        got = api.run(dataclasses.replace(serve, scenario=scenario),
                      device="cpu")
        np.testing.assert_array_equal(got.x, clean.x)


def test_simulator_runs_a_scenario_world():
    A, b = make_synthetic(1.0, 1.0, n=8, m=40, d=30, seed=0)
    spec = api.ExperimentSpec(objective=LogRegProblem(A, b, device="cpu"),
                              scheduler="pure", timing="poisson:slow=8",
                              T=120, stepsize=0.004, log_every=20,
                              scenario="straggler:k=2,factor=8,every=16,"
                                       "span=4")
    res = api.run(spec, device="cpu")
    world = scenarios.realise_world(spec.make_scenario(),
                                    spec.make_scheduler(),
                                    spec.make_timing(), 120, seed=0)
    np.testing.assert_array_equal(res.schedule.workers,
                                  world.schedule.workers)
    assert res.extra["scenario"] == spec.scenario
    plain = api.run(dataclasses.replace(spec, scenario=None), device="cpu")
    assert not np.array_equal(res.schedule.assign_iters,
                              plain.schedule.assign_iters)
