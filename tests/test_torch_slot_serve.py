"""The port's continuous-batching slot server against the JAX ``SlotServer``.

The JAX suite's ``TINY`` dense config (and a tiny mamba2 for the ssm
family) in f32; the JAX params are carried into the port.  The port's
``SlotServer`` runs on the CPU with the eager chunk (``capture=False`` is
the CPU route; the CUDA graph route is held to it on the card by
``test_torch_cuda.py``).  Admission, completions, TTFT and the lowered
``Schedule`` are host bookkeeping on numpy RNG, so they must be equal; the
greedy tokens come from f32 logits that agree to ~1e-7 and must be equal
too.  Sampled streams are the port's own (a counter hash, not threefry):
they are held to the JAX contract, not to JAX's tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402
from jax.sharding import Mesh                               # noqa: E402

from repro.configs import get_arch                          # noqa: E402
from repro.distributed import SlotConfig as JSlotConfig     # noqa: E402
from repro.distributed import SlotServer as JSlotServer     # noqa: E402
from repro.models import init_params as j_init_params       # noqa: E402
from repro_torch.api import ExperimentSpec, ServeJob, run   # noqa: E402
from repro_torch.api.backends import ServeBackend           # noqa: E402
from repro_torch.configs import get_arch as t_get_arch      # noqa: E402
from repro_torch.distributed import (OverloadPolicy,        # noqa: E402
                                     Server, ServeConfig, SlotConfig,
                                     SlotServer)
from repro_torch.models import model as TM                  # noqa: E402
from repro_torch.scenarios import render_report, tau_report  # noqa: E402
from torch_parity import port_params, tree_f32              # noqa: E402

TINY = dict(n_layers=1, d_model=8, n_heads=1, n_kv_heads=1, d_ff=16,
            vocab=127)
TINY_SSM = dict(n_layers=1, d_model=32, vocab=127)
FAMILIES = {"dense": ("qwen2-0.5b", TINY), "ssm": ("mamba2-370m", TINY_SSM)}
POLICIES = ["pure", "random", "shuffled", "fedbuff:b=2"]
ARRIVALS = np.array([0, 0, 1, 3, 6, 9, 9])


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _cfgs(family):
    arch, over = FAMILIES[family]
    over = dict(remat="none", dtype="float32", **over)
    return (get_arch(arch).reduced().with_(**over),
            t_get_arch(arch).reduced().with_(**over))


def _prompts(n, plen, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, plen)).astype(np.int32)


@pytest.fixture(scope="module", params=list(FAMILIES))
def world(request):
    """One JAX and one port server per family (each program built once),
    the JAX params and their port copy."""
    jcfg, tcfg = _cfgs(request.param)
    jp = tree_f32(j_init_params(jcfg, jax.random.PRNGKey(0)))
    slots = dict(n_slots=2, ctx_len=16, steps_per_launch=2)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=port_params(jp),
                jsrv=JSlotServer(jcfg, _mesh(), JSlotConfig(**slots)),
                tsrv=SlotServer(tcfg, SlotConfig(**slots), device="cpu"))


def _assert_same(got, want):
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.ttft_steps, want.ttft_steps)
    assert got.occupancy == want.occupancy
    assert (got.decode_steps, got.chunks, got.tap_rows) == \
        (want.decode_steps, want.chunks, want.tap_rows)
    assert got.evictions == want.evictions
    assert got.timeouts == want.timeouts
    sg, sw = got.schedule, want.schedule
    for f in ("workers", "assign_iters", "finish_times", "active_jobs",
              "unfinished_assign_iters"):
        np.testing.assert_array_equal(getattr(sg, f), getattr(sw, f),
                                      err_msg=f)
    assert (sg.wait_b, sg.n_workers) == (sw.wait_b, sw.n_workers)


@pytest.mark.parametrize("arrivals", [None, ARRIVALS], ids=["queued", "arrivals"])
@pytest.mark.parametrize("admission", POLICIES)
def test_slot_server_matches_jax(world, admission, arrivals):
    prompts = _prompts(7, 5, world["jcfg"].vocab)
    want = world["jsrv"].serve(world["jp"], prompts, 6, admission=admission,
                               arrivals=arrivals)
    got = world["tsrv"].serve(world["tp"], prompts, 6, admission=admission,
                              arrivals=arrivals)
    _assert_same(got, want)
    assert got.host_waits == 0 and got.chunk_device_ms is None


def test_programs_built_once_across_serves(world):
    srv = world["tsrv"]
    prompts = _prompts(7, 5, world["jcfg"].vocab)
    srv.serve(world["tp"], prompts, 6, admission="shuffled",
              arrivals=ARRIVALS)
    srv.serve(world["tp"], prompts, 6)
    assert srv.compile_counts() == {"chunk": 0}           # eager: no capture


def test_quarantine_matches_jax(world):
    """NaN params: every lane is quarantined at its first decode step, as
    in the JAX server; then a healthy serve on the same instance."""
    bad = jax.tree_util.tree_map(lambda x: jnp.full_like(x, np.nan),
                                 world["jp"])
    prompts = _prompts(3, 5, world["jcfg"].vocab)
    arr = np.array([0, 0, 4])
    want = world["jsrv"].serve(bad, prompts, 5, arrivals=arr)
    got = world["tsrv"].serve(port_params(bad), prompts, 5, arrivals=arr)
    _assert_same(got, want)
    assert sorted(got.evictions) == [0, 1, 2]
    assert np.all(got.tokens[:, 1:] == -1)
    rep = tau_report(got.schedule, "pure", evictions=got.evictions,
                     timeouts=got.timeouts)
    assert "evicted (quarantine)" in render_report(rep)
    ok = world["tsrv"].serve(world["tp"], prompts, 5)
    assert ok.evictions == {} and np.all(ok.tokens >= 0)


def test_deadline_timeouts_match_jax(world):
    cfg = world["jcfg"]
    jsrv = JSlotServer(cfg, _mesh(), JSlotConfig(n_slots=1, ctx_len=16,
                                                 steps_per_launch=2))
    tsrv = SlotServer(world["tcfg"], SlotConfig(n_slots=1, ctx_len=16,
                                                steps_per_launch=2),
                      device="cpu")
    prompts = _prompts(4, 5, cfg.vocab)
    want = jsrv.serve(world["jp"], prompts, 4, deadline=2)
    got = tsrv.serve(world["tp"], prompts, 4, deadline=2)
    _assert_same(got, want)
    assert got.timeouts
    for r in got.timeouts:
        assert np.all(got.tokens[r] == -1) and got.ttft_steps[r] == -1
    with pytest.raises(ValueError, match="deadline"):
        tsrv.serve(world["tp"], prompts, 4, deadline=-1)


def test_tap_streams_every_token_in_order(world):
    prompts = _prompts(4, 5, world["jcfg"].vocab)
    streamed, steps = {}, {}
    res = world["tsrv"].serve(
        world["tp"], prompts, 5,
        on_token=lambda rid, tok, step: (streamed.setdefault(rid, []).append(
            tok), steps.setdefault(rid, []).append(step)))
    for rid in range(4):
        np.testing.assert_array_equal(streamed[rid], res.tokens[rid, 1:])
        assert steps[rid] == sorted(steps[rid])
    assert res.tap_rows == res.decode_steps == res.chunks * 2


def _lockstep(tcfg, tp, prompts, T, ctx):
    """The port's lock-step lane: batched prefill, argmax, T − 1 steps."""
    logits, cache = TM.prefill(tcfg, tp, {"tokens": torch.as_tensor(
        prompts, dtype=torch.int64)}, ctx_len=ctx)
    tok0 = torch.argmax(logits, dim=-1)
    srv = Server(tcfg, ServeConfig(batch=prompts.shape[0], ctx_len=ctx),
                 device="cpu")
    gen = srv.generate(tp, tok0.numpy(), T - 1, start_pos=prompts.shape[1],
                       cache=cache)
    return np.concatenate([tok0.numpy().astype(np.int32)[:, None], gen],
                          axis=1)


def test_slot_lane_equals_the_lockstep_lane(world):
    """Full static batch, no arrivals, greedy: the slot lane reproduces the
    port's lock-step lane token for token."""
    prompts = _prompts(3, 5, world["jcfg"].vocab, seed=1)
    srv = SlotServer(world["tcfg"], SlotConfig(n_slots=3, ctx_len=11,
                                               steps_per_launch=2),
                     device="cpu")
    res = srv.serve(world["tp"], prompts, 6)
    np.testing.assert_array_equal(
        res.tokens, _lockstep(world["tcfg"], world["tp"], prompts, 6, 11))


def test_admission_rotates_through_every_slot(world):
    """More requests than slots, staggered arrivals: each request lands in
    a slot another request used before, and each must decode exactly as it
    would alone (a wrong admission would leak a neighbour's cache row)."""
    prompts = _prompts(7, 5, world["jcfg"].vocab, seed=2)
    srv = SlotServer(world["tcfg"], SlotConfig(n_slots=3, ctx_len=12,
                                               steps_per_launch=2),
                     device="cpu")
    res = srv.serve(world["tp"], prompts, 5, arrivals=ARRIVALS)
    for rid in range(7):
        alone = _lockstep(world["tcfg"], world["tp"], prompts[rid:rid + 1],
                          5, 12)
        np.testing.assert_array_equal(res.tokens[rid:rid + 1], alone,
                                      err_msg=f"request {rid}")


def test_single_token_budget_completes_at_admission(world):
    prompts = _prompts(3, 5, world["jcfg"].vocab)
    want = world["jsrv"].serve(world["jp"], prompts, 1)
    got = world["tsrv"].serve(world["tp"], prompts, 1)
    _assert_same(got, want)
    assert got.chunks == 0 and got.tap_rows == 0


def test_sampled_streams_independent_of_pool_width():
    """A request's sampled stream is a function of (seed, rid, step): the
    same with 1 slot or 2, distinct across requests, moved by the seed."""
    _, tcfg = _cfgs("dense")
    tp = TM.init_params(tcfg, 0, device="cpu")
    prompts = _prompts(4, 5, tcfg.vocab, seed=7)
    res = {}
    for n_slots in (1, 2):
        srv = SlotServer(tcfg, SlotConfig(n_slots=n_slots, ctx_len=16,
                                          steps_per_launch=2,
                                          temperature=0.8, seed=11),
                         device="cpu")
        res[n_slots] = srv.serve(tp, prompts, 6).tokens
        assert srv.compile_counts() == {"chunk": 0}
    np.testing.assert_array_equal(res[1], res[2])
    for a in range(4):
        for b in range(a + 1, 4):
            assert not np.array_equal(res[2][a, 1:], res[2][b, 1:]), (a, b)
    other = SlotServer(tcfg, SlotConfig(n_slots=2, ctx_len=16,
                                        steps_per_launch=2, temperature=0.8,
                                        seed=12), device="cpu")
    assert not np.array_equal(other.serve(tp, prompts, 6).tokens, res[2])
    greedy = SlotServer(tcfg, SlotConfig(n_slots=2, ctx_len=16,
                                         steps_per_launch=2), device="cpu")
    assert not np.array_equal(greedy.serve(tp, prompts, 6).tokens, res[2])


@pytest.mark.parametrize("kw", [dict(retry=object()),
                                dict(overload=OverloadPolicy(4)),
                                dict(drain_after=4), dict(faults=object()),
                                dict(snapshot=object()),
                                dict(resume_from="somewhere")],
                         ids=lambda kw: next(iter(kw)))
def test_resilience_kwargs_raise(world, kw):
    prompts = _prompts(2, 5, world["jcfg"].vocab)
    with pytest.raises(NotImplementedError, match="item 11c"):
        world["tsrv"].serve(world["tp"], prompts, 4, **kw)


def test_refuses_budget_overflow_other_families_and_a_recorder():
    _, tcfg = _cfgs("dense")
    srv = SlotServer(tcfg, SlotConfig(n_slots=1, ctx_len=8), device="cpu")
    tp = TM.init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        srv.serve(tp, _prompts(1, 5, tcfg.vocab), 4)
    with pytest.raises(NotImplementedError, match="vlm"):
        SlotServer(t_get_arch("pixtral-12b").reduced(),
                   SlotConfig(n_slots=1, ctx_len=8), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SlotServer(t_get_arch("zamba2-7b").reduced(),
                   SlotConfig(n_slots=1, ctx_len=8), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        SlotServer(tcfg, SlotConfig(n_slots=1, ctx_len=8), device="cpu",
                   recorder=object())


TINY_OVR = tuple(dict(TINY, dtype="float32").items())


def test_backend_slot_route_matches_lockstep_route():
    """``run`` with ``n_slots == batch`` and no arrivals emits the lock-step
    route's token matrix (same prompt stream by construction)."""
    lock = run(ExperimentSpec(objective=ServeJob(
        batch=3, prompt_len=5, arch_overrides=TINY_OVR), T=6), device="cpu")
    slot = run(ExperimentSpec(objective=ServeJob(
        batch=3, prompt_len=5, arch_overrides=TINY_OVR, n_slots=3,
        steps_per_launch=2), T=6), device="cpu")
    np.testing.assert_array_equal(lock.x, slot.x)
    np.testing.assert_array_equal(lock.extra["prompts"],
                                  slot.extra["prompts"])
    assert slot.backend == "serve" and slot.schedule is not None
    e = slot.extra
    assert e["tau_report"]["global"]["tau_c"] <= 3 + 1
    assert 0 < e["occupancy"] <= 1
    assert e["device"] == "cpu" and e["graph_replays"] == 0
    assert e["flash_launches"] == e["ssd_launches"] == 0 == e["host_waits"]
    assert e["compile_counts"] == {"chunk": 0}


def test_backend_slot_route_with_arrivals_fedbuff_and_deadline():
    res = ServeBackend(device="cpu").run(ExperimentSpec(
        objective=ServeJob(batch=2, prompt_len=5, arch_overrides=TINY_OVR,
                           n_slots=2, n_requests=5, admission="fedbuff:b=2",
                           arrival="poisson:gap=3", steps_per_launch=2),
        T=5, seed=2))
    assert res.x.shape == (5, 5) and np.all(res.x >= 0)
    assert res.extra["ttft_steps"].shape == (5,)
    assert res.extra["tau_report"]["policy"] == "fedbuff"
    want = np.random.default_rng(2).integers(0, 127, (5, 5))
    np.testing.assert_array_equal(res.extra["prompts"], want)
    late = ServeBackend(device="cpu").run(ExperimentSpec(
        objective=ServeJob(batch=2, prompt_len=5, arch_overrides=TINY_OVR,
                           n_slots=1, n_requests=3, deadline=1,
                           steps_per_launch=2), T=4))
    assert late.extra["timeouts"]
    assert late.extra["tau_report"]["degraded"]["timeouts"] == \
        late.extra["timeouts"]


def test_backend_slot_route_refuses_a_scenario():
    with pytest.raises(NotImplementedError, match="scenario"):
        run(ExperimentSpec(objective=ServeJob(
            arch_overrides=TINY_OVR, n_slots=2), T=4,
            scenario="straggler:k=1,factor=2"), device="cpu")
