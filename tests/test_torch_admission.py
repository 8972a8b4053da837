"""The port's admission layer against the JAX package's, bit for bit.

``repro_torch.distributed.admission`` is a copy of the framework-free JAX
module (numpy RNG), so every policy's pick sequence, every arrival draw and
every lowered ``Schedule`` must be equal, not close.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.distributed import admission as JA             # noqa: E402
from repro_torch.core import PATTERNS, REGISTRY           # noqa: E402
from repro_torch.distributed import admission as TA       # noqa: E402

POLICIES = sorted(REGISTRY)


@pytest.mark.parametrize("spec", ["pure", "fedbuff:b=3", "random", "rr",
                                  "shuffled:b=1", "minibatch:b=2"])
def test_parse_admission_matches_jax(spec):
    assert TA.parse_admission(spec) == JA.parse_admission(spec)


@pytest.mark.parametrize("bad", ["nope", "pure:k=2"])
def test_parse_admission_refuses_as_jax_does(bad):
    with pytest.raises(ValueError) as jerr:
        JA.parse_admission(bad)
    with pytest.raises(ValueError) as terr:
        TA.parse_admission(bad)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", [0, 3])
def test_draw_arrivals_matches_jax(pattern, seed):
    for spec in (f"{pattern}", f"{pattern}:gap=2.5"):
        want = JA.draw_arrivals(9, spec, seed=seed)
        got = TA.draw_arrivals(9, spec, seed=seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TA.draw_arrivals(4, None),
                                  JA.draw_arrivals(4, None))


def _drive(mod, name, b, seed):
    """A fixed script of arrivals, picks, completions, a cancel and a
    requeue against one policy; returns everything it observed."""
    n = 11
    pol = mod.AdmissionPolicy(name, n, b=b, seed=seed)
    out = [pol.wait_b]
    arrived, in_flight, live = set(), 0, []
    for step in range(40):
        arrived |= {r for r in range(n) if r <= step // 2}
        if step == 7:
            pol.cancel(9)
        if step == 13 and live:
            pol.requeue(live[0])
        for _ in range(2):
            q = pol.pick(arrived, in_flight)
            out.append(q)
            if q is not None:
                live.append(q)
                in_flight += 1
        if live and step % 3 == 2:
            done = live.pop(0)
            in_flight -= 1
            pol.notify_completion(done)
        out.append(pol.n_queued)
    out.append(pol.state_dict())
    return out


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("b,seed", [(1, 0), (3, 5)])
def test_policy_sequences_match_jax(name, b, seed):
    assert _drive(TA, name, b, seed) == _drive(JA, name, b, seed)


def _trace(mod):
    tr = mod.AdmissionTrace(6, wait_b=2)
    tr.admitted(0, 0)
    tr.admitted(1, 0)
    tr.completed(1, 1, 4, 2)
    tr.admitted(2, 4)
    tr.evicted(2, 6)
    tr.completed(0, 0, 6, 2)
    tr.timed_out(3, 8)
    tr.admitted(4, 8)
    tr.completed(2, 1, 9, 2)
    tr.completed(4, 0, 12, 1)
    return tr


def test_trace_lowers_to_the_same_schedule():
    got, want = _trace(TA), _trace(JA)
    sg, sw = got.schedule(), want.schedule()
    for f in ("workers", "assign_iters", "finish_times", "active_jobs",
              "unfinished_assign_iters"):
        a, b = getattr(sg, f), getattr(sw, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (sg.wait_b, sg.n_workers) == (sw.wait_b, sw.n_workers)
    np.testing.assert_array_equal(sg.delays, sw.delays)
    assert got.state_dict() == want.state_dict()
    assert got.evictions == want.evictions and got.timeouts == want.timeouts
