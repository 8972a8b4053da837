"""Serving resilience in the port, held to the JAX ``SlotServer``.

The contracts of ``tests/test_resilience.py`` that need no ``Recorder``
run on the port's ``SlotServer`` (the JAX suite's ``TINY`` dense config,
on the CPU's eager route), and each resilient serve is also run through
the JAX ``SlotServer`` on the same params (f32, carried by
``params_from_numpy``), prompts, arrivals, faults, retry, overload and
drain: greedy tokens, TTFT, evictions, timeouts, shed, drained, attempts
and the lowered ``Schedule`` must be equal.  A snapshot's ``meta.json``
ledger, admission policy and admission trace must equal the JAX
snapshot's at the same boundary.  The SIGKILL serve gate runs the writer
in a subprocess.  Sampled streams are the port's own (a counter hash, not
threefry): they are held to the JAX contract, not to JAX's tokens.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                      # noqa: E402
from jax.sharding import Mesh                                   # noqa: E402

import repro.checkpoint as jckpt                                # noqa: E402
import repro.distributed as jdist                               # noqa: E402
import repro.faults as jfaults                                  # noqa: E402
from repro.configs import get_arch                              # noqa: E402
from repro.core.delays import TimingModel as JTimingModel       # noqa: E402
from repro.distributed.slot_serve import _Ledger as JLedger     # noqa: E402
from repro.models import init_params as j_init_params           # noqa: E402
from repro_torch.api import ExperimentSpec, ServeJob, run       # noqa: E402
from repro_torch.api.backends import ServeBackend               # noqa: E402
from repro_torch.checkpoint import AsyncSnapshotter             # noqa: E402
from repro_torch.configs import get_arch as t_get_arch          # noqa: E402
from repro_torch.core.delays import TimingModel                 # noqa: E402
from repro_torch.distributed import (AdmissionPolicy,           # noqa: E402
                                     OverloadPolicy, RetryPolicy,
                                     ServePreempted, SlotConfig, SlotServer,
                                     draw_arrivals)
from repro_torch.distributed.slot_serve import _Ledger          # noqa: E402
from repro_torch.faults import ServeFaults, realise_serve_faults  # noqa: E402
from repro_torch.scenarios import render_report, tau_report     # noqa: E402
from torch_parity import port_params, tree_f32                  # noqa: E402

TINY = dict(n_layers=1, d_model=8, n_heads=1, n_kv_heads=1, d_ff=16,
            vocab=127)
TINY_OVR = tuple(dict(TINY, dtype="float32").items())
K = 2


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _prompts(n, plen, vocab=127, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (n, plen)).astype(np.int32)


@pytest.fixture(scope="module")
def world():
    """The dense TINY config in f32 in both packages, the JAX params and
    their port copy, and one server per (package, n_slots, ctx), each
    built once (the JAX chunk compiles per instance)."""
    over = dict(remat="none", dtype="float32", **TINY)
    jcfg = get_arch("qwen2-0.5b").reduced().with_(**over)
    tcfg = t_get_arch("qwen2-0.5b").reduced().with_(**over)
    jp = tree_f32(j_init_params(jcfg, jax.random.PRNGKey(0)))
    servers = {}

    def server(pkg, n_slots, ctx, temperature=0.0):
        key = (pkg, n_slots, ctx, temperature)
        if key not in servers:
            if pkg == "jax":
                servers[key] = jdist.SlotServer(
                    jcfg, _mesh(), jdist.SlotConfig(
                        n_slots=n_slots, ctx_len=ctx, steps_per_launch=K,
                        temperature=temperature))
            else:
                servers[key] = SlotServer(
                    tcfg, SlotConfig(n_slots=n_slots, ctx_len=ctx,
                                     steps_per_launch=K,
                                     temperature=temperature),
                    device="cpu")
        return servers[key]

    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=port_params(jp),
                server=server)


def _port(world, n_slots, ctx, temperature=0.0):
    return world["server"]("torch", n_slots, ctx, temperature)


def _jax_kw(kw):
    """The port's resilience kwargs as the JAX package's objects."""
    out = dict(kw)
    if "retry" in kw:
        r = kw["retry"]
        out["retry"] = jdist.RetryPolicy(r.max_attempts, r.backoff_base,
                                         r.backoff_factor)
    if "overload" in kw:
        o = kw["overload"]
        out["overload"] = jdist.OverloadPolicy(o.queue_cap, o.shed)
    if "faults" in kw:
        f = kw["faults"]
        out["faults"] = jfaults.ServeFaults(poisons=f.poisons,
                                            preempt_steps=f.preempt_steps)
    return out


def _assert_same(got, want):
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.ttft_steps, want.ttft_steps)
    for f in ("evictions", "timeouts", "shed", "drained", "attempts",
              "resumed_from", "occupancy", "decode_steps", "chunks",
              "tap_rows"):
        assert getattr(got, f) == getattr(want, f), f
    sg, sw = got.schedule, want.schedule
    for f in ("workers", "assign_iters", "finish_times", "active_jobs",
              "unfinished_assign_iters"):
        np.testing.assert_array_equal(getattr(sg, f), getattr(sw, f),
                                      err_msg=f)


def _both(world, n_slots, n, plen, T, ctx=None, arrivals=None, **kw):
    """The same serve through the JAX and the port server; asserts every
    field equal and returns the port's result."""
    ctx = ctx or plen + T
    prompts = _prompts(n, plen)
    want = world["server"]("jax", n_slots, ctx).serve(
        world["jp"], prompts, T, arrivals=arrivals, **_jax_kw(kw))
    got = _port(world, n_slots, ctx).serve(world["tp"], prompts, T,
                                           arrivals=arrivals, **kw)
    _assert_same(got, want)
    return got


def _accounted(res, n_req):
    """Every rid lands in exactly one terminal bucket (a full row counts as
    'completed'); returns the per-rid bucket map."""
    buckets = {}
    for rid in range(n_req):
        hits = [name for name, m in (("evicted", res.evictions),
                                     ("timed_out", res.timeouts),
                                     ("shed", res.shed),
                                     ("drained", res.drained)) if rid in m]
        if not hits:
            assert (res.tokens[rid] >= 0).all(), rid
            buckets[rid] = "completed"
        else:
            assert len(hits) == 1, f"rid {rid} in several buckets: {hits}"
            buckets[rid] = hits[0]
    return buckets


# ---------------------------------------------------------------------------
# policies, the timing pattern, the fault grammar, the ledger
# ---------------------------------------------------------------------------
def test_retry_policy_backoff_and_validation():
    rp = RetryPolicy(max_attempts=3, backoff_base=4, backoff_factor=2.0)
    assert [rp.backoff_steps(f) for f in (1, 2, 3)] == [4, 8, 16]
    assert RetryPolicy(backoff_base=0).backoff_steps(5) == 0
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="backoff_factor"):
        RetryPolicy(backoff_factor=0.5)
    with pytest.raises(ValueError, match="queue_cap"):
        OverloadPolicy(0)
    with pytest.raises(ValueError, match="shed policy"):
        OverloadPolicy(2, shed="nope")


def test_bursty_timing_pattern():
    s = 3.0
    batch = TimingModel(np.full(64, s), "bursty", seed=7).sample_round(
        np.arange(64))
    oracle = TimingModel(np.full(64, s), "bursty", seed=7)
    np.testing.assert_allclose(batch, [oracle.sample(i) for i in range(64)])
    assert set(np.round(batch, 8)) <= {4.0 * s, 1e-6}
    assert (batch < 1e-3).any() and (batch > s).any()
    np.testing.assert_array_equal(batch, JTimingModel(
        np.full(64, s), "bursty", seed=7).sample_round(np.arange(64)))


def test_serve_fault_grammar():
    f = realise_serve_faults(
        "slot_poison:rid=1,step=4,every=0;serve_preempt:at=6,every=0",
        n_requests=4, horizon=16)
    assert f.poisons == ((1, 4),) and f.preempt_steps == (6,)
    assert not f.empty
    f2 = realise_serve_faults("slot_poison:rid=0,step=2,every=4",
                              n_requests=2, horizon=12)
    assert f2.poisons == ((0, 2), (0, 6), (0, 10))
    assert realise_serve_faults("nan_grad:k=1,every=4", 2, 8).empty
    with pytest.raises(ValueError, match="rid"):
        realise_serve_faults("slot_poison:rid=-1", 2, 8)
    with pytest.raises(ValueError, match="at"):
        realise_serve_faults("serve_preempt:at=0", 2, 8)


def _fill(L):
    L.t, L.chunks, L.busy_steps = 4, 2, 7
    L.slot_rid = [1, -1]
    L.state_of = {0: "done", 1: "inflight", 2: "queued"}
    L.fin = {0: 3, 1: 6}
    L.admit_t = {0: 0, 1: 2}
    L.tries = {2: 1}
    L.emitted = {2: [5, 9]}
    L.outputs = {1: [torch.tensor([7]), 8, 9]}
    L.cur_evict = {2: 3}
    L.evict_events = [[2, 3]]
    L.evt_cursor = 1
    return L


def test_ledger_json_roundtrip_matches_jax():
    d = _fill(_Ledger(3, 2, [0, 1, 5])).to_json()
    L2 = _Ledger.from_json(d)
    assert L2.to_json() == d
    assert L2.in_flight == 1 and L2.done == 1
    assert L2.outputs == {1: [7, 8, 9]}
    jl = _fill(JLedger(3, 2, [0, 1, 5]))
    jl.outputs = {1: [7, 8, 9]}
    assert jl.to_json() == d
    assert JLedger.from_json(d).to_json() == d


def test_admission_policy_state_roundtrip():
    a = AdmissionPolicy("shuffled", 6, seed=3)
    b = AdmissionPolicy("shuffled", 6, seed=99)
    arrived = set(range(6))
    a.notify_completion(a.pick(arrived, 0))
    b.load_state(a.state_dict())
    for _ in range(3):
        pa, pb = a.pick(arrived, 1), b.pick(arrived, 1)
        assert pa == pb
        if pa is not None:
            a.notify_completion(pa)
            b.notify_completion(pb)


# ---------------------------------------------------------------------------
# the clean-world no-op, retry, deadlines, overload, drain: port ≡ JAX
# ---------------------------------------------------------------------------
def test_clean_world_retry_is_token_identical(world):
    prompts, arr = _prompts(3, 4), np.array([0, 1, 3])
    srv = _port(world, 2, 10)
    plain = srv.serve(world["tp"], prompts, 6, arrivals=arr)
    armed = _both(world, 2, 3, 4, 6, arrivals=arr,
                  retry=RetryPolicy(max_attempts=3),
                  overload=OverloadPolicy(queue_cap=8))
    np.testing.assert_array_equal(plain.tokens, armed.tokens)
    assert armed.evictions == {} and armed.attempts == {}
    assert armed.shed == {} and armed.drained == {}
    assert armed.resumed_from is None
    assert srv.compile_counts() == {"chunk": 0}       # eager: no capture


def test_poison_retry_recovers_full_row(world):
    clean = _port(world, 2, 10).serve(world["tp"], _prompts(2, 4), 6)
    res = _both(world, 2, 2, 4, 6, faults=ServeFaults(poisons=((1, 2),)),
                retry=RetryPolicy(max_attempts=2, backoff_base=2))
    np.testing.assert_array_equal(clean.tokens, res.tokens)
    assert res.attempts == {1: 1} and res.evictions == {}
    assert _accounted(res, 2) == {0: "completed", 1: "completed"}


def test_without_retry_poison_is_terminal(world):
    res = _both(world, 2, 2, 4, 6, faults=ServeFaults(poisons=((1, 2),)))
    assert res.evictions == {1: 2}
    assert (res.tokens[1, :3] >= 0).all() and (res.tokens[1, 3:] == -1).all()
    assert (res.tokens[0] >= 0).all()


def test_retry_exhaustion_lands_in_evictions_with_attempts(world):
    cells = tuple((0, s) for s in range(1, 32))
    res = _both(world, 1, 1, 4, 4, faults=ServeFaults(poisons=cells),
                retry=RetryPolicy(max_attempts=2, backoff_base=1))
    assert 0 in res.evictions and res.attempts == {0: 2}
    row = res.tokens[0]
    k = int((row >= 0).sum())
    assert 0 < k < 4 and (row[:k] >= 0).all() and (row[k:] == -1).all()
    assert _accounted(res, 1) == {0: "evicted"}


def test_retried_stream_reseeds_per_attempt(world):
    """Under sampling a retried request's stream is reproducible; a serve
    armed with retry but never degraded draws attempt 0's streams, the
    ones of a serve without retry; attempt a > 0 hashes a stream of its
    own."""
    def go(**kw):
        return _port(world, 1, 10, temperature=0.8).serve(
            world["tp"], _prompts(1, 4), 6, **kw)

    retry = RetryPolicy(max_attempts=2, backoff_base=2)
    kw = dict(faults=ServeFaults(poisons=((0, 2),)), retry=retry)
    a, b = go(**kw), go(**kw)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.attempts == {0: 1} and (a.tokens[0] >= 0).all()
    clean = go()
    np.testing.assert_array_equal(go(retry=retry).tokens, clean.tokens)
    np.testing.assert_array_equal(a.tokens[0, :3], clean.tokens[0, :3])
    lanes = _port(world, 1, 10, temperature=0.8)._lanes
    logits = torch.zeros((1, 127))
    draws = []
    for attempt in (0, 1, 2):
        lanes.attempt.fill_(attempt)
        draws.append([int(lanes._sample(logits)) for lanes.ctr[0] in
                      range(8)])
    lanes.attempt.zero_()
    lanes.ctr.zero_()
    assert draws[0] != draws[1] != draws[2] != draws[0]


def test_deadline_zero_times_out_at_first_sweep(world):
    res = _both(world, 1, 3, 4, 4, deadline=0)
    assert len(res.timeouts) == 2 and set(res.timeouts.values()) == {2}
    assert sorted(v for v in res.ttft_steps if v < 0) == [-1, -1]
    assert _accounted(res, 3)[0] == "completed"


def test_deadline_timeout_retries_with_backoff_then_completes(world):
    clean = _port(world, 2, 8).serve(world["tp"], _prompts(2, 4), 4)
    res = _both(world, 1, 2, 4, 4, ctx=8, deadline=0,
                retry=RetryPolicy(max_attempts=3, backoff_base=2))
    assert res.timeouts == {} and res.attempts.get(1, 0) >= 1
    np.testing.assert_array_equal(clean.tokens, res.tokens)
    assert _accounted(res, 2) == {0: "completed", 1: "completed"}


@pytest.mark.parametrize("shed,victims", [("reject-new", {3, 4, 5}),
                                          ("drop-oldest", {1, 2, 3})])
def test_shed_policies_are_distinguishable(world, shed, victims):
    res = _both(world, 1, 6, 4, 4,
                overload=OverloadPolicy(queue_cap=2, shed=shed))
    assert set(res.shed) == victims
    b = _accounted(res, 6)
    assert sum(1 for v in b.values() if v == "completed") == 3


def test_readmission_respects_drop_oldest_shedding(world):
    res = _both(world, 1, 4, 4, 4,
                faults=ServeFaults(poisons=tuple((0, s) for s in range(1, 8))),
                retry=RetryPolicy(max_attempts=2, backoff_base=2),
                overload=OverloadPolicy(queue_cap=1, shed="drop-oldest"))
    assert _accounted(res, 4)[0] in ("evicted", "shed")
    assert res.shed and res.attempts.get(0, 0) >= 1


def test_graceful_drain(world):
    res = _both(world, 1, 4, 4, 6, arrivals=np.array([0, 0, 8, 12]),
                drain_after=2)
    assert (res.tokens[0] >= 0).all()
    assert res.drained == {1: 2, 2: 2, 3: 2}
    assert _accounted(res, 4) == {0: "completed", 1: "drained",
                                  2: "drained", 3: "drained"}
    with pytest.raises(ValueError, match="drain_after"):
        _port(world, 1, 10).serve(world["tp"], _prompts(1, 4), 6,
                                  drain_after=-1)


# ---------------------------------------------------------------------------
# durability: snapshot, preempt, resume; chaos; SIGKILL
# ---------------------------------------------------------------------------
def _metas(snapdir):
    out = {}
    for name in sorted(os.listdir(snapdir)):
        with open(os.path.join(snapdir, name, "meta.json")) as f:
            m = json.load(f)
        out[name] = {k: m[k] for k in ("serve_ledger", "admission_policy",
                                       "admission_trace", "round", "step",
                                       "kind")}
    return out


def test_snapshot_ledgers_equal_the_jax_snapshots(world, tmp_path):
    """At every boundary the port offers, its snapshot's ledger, admission
    policy and admission trace equal the JAX snapshot's."""
    kw = dict(arrivals=np.array([0, 0, 1, 3, 6]), admission="shuffled",
              faults=ServeFaults(poisons=((1, 2), (3, 6))),
              retry=RetryPolicy(max_attempts=2, backoff_base=2),
              overload=OverloadPolicy(queue_cap=2, shed="drop-oldest"))
    prompts = _prompts(5, 4)
    world["server"]("jax", 2, 10).serve(
        world["jp"], prompts, 6, **_jax_kw(kw),
        snapshot=jckpt.AsyncSnapshotter(str(tmp_path / "j"), 2, keep=50))
    _port(world, 2, 10).serve(
        world["tp"], prompts, 6, **kw,
        snapshot=AsyncSnapshotter(str(tmp_path / "t"), 2, keep=50))
    got, want = _metas(tmp_path / "t"), _metas(tmp_path / "j")
    assert len(got) >= 3 and got == want


def test_preempt_snapshot_resume_bitwise(world, tmp_path):
    """``serve_preempt`` raises at its boundary after a forced snapshot; the
    resumed serve equals the uninterrupted one, and the JAX package's
    preempted and resumed serve."""
    prompts, arr = _prompts(3, 4), np.array([0, 0, 4])
    srv = _port(world, 2, 10)
    clean = srv.serve(world["tp"], prompts, 6, arrivals=arr)
    faults = ServeFaults(preempt_steps=(4,))
    snapdir = str(tmp_path / "t")
    with pytest.raises(ServePreempted) as ei:
        srv.serve(world["tp"], prompts, 6, arrivals=arr, faults=faults,
                  snapshot=AsyncSnapshotter(snapdir, 2, keep=3))
    assert ei.value.at == 4 and ei.value.step >= 4
    r, latest = AsyncSnapshotter.latest(snapdir)
    assert r == ei.value.step
    res = srv.serve(world["tp"], prompts, 6, arrivals=arr, faults=faults,
                    resume_from=latest)
    assert res.resumed_from == r
    np.testing.assert_array_equal(clean.tokens, res.tokens)
    np.testing.assert_array_equal(clean.ttft_steps, res.ttft_steps)
    assert res.chunks == clean.chunks               # lifetime accounting
    # the JAX package's preempted serve, resumed
    jsrv = world["server"]("jax", 2, 10)
    jf = jfaults.ServeFaults(preempt_steps=(4,))
    with pytest.raises(jdist.ServePreempted):
        jsrv.serve(world["jp"], prompts, 6, arrivals=arr, faults=jf,
                   snapshot=jckpt.AsyncSnapshotter(str(tmp_path / "j"), 2))
    want = jsrv.serve(world["jp"], prompts, 6, arrivals=arr, faults=jf,
                      resume_from=jckpt.AsyncSnapshotter.latest(
                          str(tmp_path / "j"))[1])
    _assert_same(res, want)
    with pytest.raises(ValueError, match="geometry"):
        srv.serve(world["tp"], _prompts(4, 4), 6, resume_from=latest)


def test_chaos_soak_no_silent_loss(world, tmp_path):
    """Poison + driver preemption + bursty arrivals + a bounded queue +
    retries, resumed across the preemption: every request is completed or
    in exactly one degraded bucket, as in the JAX package's run."""
    n = 6
    arr = draw_arrivals(n, "bursty:gap=2", seed=3)
    spec = "slot_poison:rid=1,step=3,every=1;serve_preempt:at=8,every=0"
    faults = realise_serve_faults(spec, n_requests=n, horizon=256, seed=3)
    assert faults.poisons and faults.preempt_steps == (8,)
    kw = dict(arrivals=arr, faults=faults,
              retry=RetryPolicy(max_attempts=2, backoff_base=2),
              overload=OverloadPolicy(queue_cap=3, shed="drop-oldest"))

    def soak(srv, params, snapshotter, snapdir, kw):
        resume, hops = None, 0
        while True:
            try:
                return srv.serve(params, _prompts(n, 4), 5, **kw,
                                 snapshot=snapshotter(snapdir, 2, keep=3),
                                 resume_from=resume), hops
            except (ServePreempted, jdist.ServePreempted):
                hops += 1
                assert hops <= 2, "the preemption loop did not converge"
                resume = snapshotter.latest(snapdir)[1]

    res, hops = soak(_port(world, 2, 9), world["tp"], AsyncSnapshotter,
                     str(tmp_path / "t"), kw)
    want, jhops = soak(world["server"]("jax", 2, 9), world["jp"],
                       jckpt.AsyncSnapshotter, str(tmp_path / "j"),
                       _jax_kw(kw))
    assert hops == jhops == 1 and res.resumed_from is not None
    _assert_same(res, want)
    buckets = _accounted(res, n)
    assert buckets[1] != "completed" and res.attempts.get(1, 0) >= 1
    rep = tau_report(res.schedule, "pure", concurrency=2,
                     scenario_spec="chaos", evictions=res.evictions,
                     timeouts=res.timeouts, shed=res.shed,
                     drained=res.drained, attempts=res.attempts)
    deg = rep["degraded"]
    assert (len(deg["evictions"]) + len(deg["timeouts"]) + len(deg["shed"])
            + len(deg["drained"])) == sum(1 for v in buckets.values()
                                          if v != "completed")
    assert render_report(rep)


@pytest.mark.parametrize("queue_cap,rid5", [(8, "shed"), (16, "completed")])
def test_chaos_cell_bookkeeping_matches_jax(world, queue_cap, rid5):
    """The card's chaos cell (``chip_smoke.py``: 32 requests, 8 slots,
    T 64, K 8, ``poisson:gap=2``, rid 1 poisoned every step from 3, rid 5
    at step 40, two attempts, drop-oldest) on the TINY model: no admission
    reads a token, so the bookkeeping is the full-width cell's.  With a
    queue of 8 rid 5's retry (eligible at 42) is shed at step 56 in both
    packages; with 16 it is re-admitted and completes its row through
    prefix replay."""
    n, T = 32, 64
    arr = draw_arrivals(n, "poisson:gap=2", seed=0)
    spec = "slot_poison:rid=1,step=3,every=1;slot_poison:rid=5,step=40,every=0"
    faults = realise_serve_faults(spec, n, 2 * (int(arr.max()) + n * T * 2
                                                + 8) + 32, seed=0)
    prompts = _prompts(n, 8)
    kw = dict(arrivals=arr, faults=faults,
              retry=RetryPolicy(max_attempts=2, backoff_base=2),
              overload=OverloadPolicy(queue_cap, "drop-oldest"))

    def server(pkg):
        cfg = (world["jcfg"], _mesh()) if pkg == "jax" else (world["tcfg"],)
        cls, conf = ((jdist.SlotServer, jdist.SlotConfig) if pkg == "jax"
                     else (SlotServer, SlotConfig))
        extra = {} if pkg == "jax" else {"device": "cpu"}
        return cls(*cfg, conf(n_slots=8, ctx_len=8 + T, steps_per_launch=8),
                   **extra)

    want = server("jax").serve(world["jp"], prompts, T, **_jax_kw(kw))
    got = server("torch").serve(world["tp"], prompts, T, **kw)
    _assert_same(got, want)
    assert got.attempts == {1: 2, 5: 1} and got.evictions == {1: 16}
    assert _accounted(got, n)[5] == rid5
    if rid5 == "shed":
        assert got.shed[5] == 56


_SERVE_CHILD = """
import sys, time
import numpy as np
from repro_torch.checkpoint import AsyncSnapshotter
from repro_torch.configs import get_arch
from repro_torch.distributed import SlotConfig, SlotServer
from repro_torch.models import init_params
cfg = get_arch("qwen2-0.5b").reduced().with_(remat="none", **{tiny!r})
params = init_params(cfg, 0, "cpu")
prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 4))
srv = SlotServer(cfg, SlotConfig(n_slots=2, ctx_len=16, steps_per_launch=2),
                 device="cpu")
srv.serve(params, prompts, 12, arrivals=np.array([0, 0, 4, 8]),
          on_token=lambda rid, tok, step: time.sleep(0.2),
          snapshot=AsyncSnapshotter(sys.argv[1], 2, keep=3))
print("FINISHED", flush=True)
"""


def test_sigkill_serve_crash_resume_gate(tmp_path):
    """A subprocess serving with snapshots is SIGKILLed mid-serve; a fresh
    server resumes from the newest restorable snapshot, and the token
    matrix and TTFT equal an uninterrupted serve's bit for bit."""
    from test_torch_checkpoint import _kill_after_first_snapshot
    from repro_torch.models import init_params

    snapdir = str(tmp_path / "crash")
    out = _kill_after_first_snapshot(_SERVE_CHILD.format(tiny=TINY), snapdir)
    assert "FINISHED" not in out, "the child finished before the kill"
    r, latest = AsyncSnapshotter.latest(snapdir)
    assert r > 0 and r % K == 0
    cfg = t_get_arch("qwen2-0.5b").reduced().with_(remat="none", **TINY)
    params = init_params(cfg, 0, "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 4))
    arr = np.array([0, 0, 4, 8])

    def fresh():
        return SlotServer(cfg, SlotConfig(n_slots=2, ctx_len=16,
                                          steps_per_launch=2), device="cpu")

    clean = fresh().serve(params, prompts, 12, arrivals=arr)
    res = fresh().serve(params, prompts, 12, arrivals=arr,
                        resume_from=latest)
    assert res.resumed_from == r
    np.testing.assert_array_equal(clean.tokens, res.tokens)
    np.testing.assert_array_equal(clean.ttft_steps, res.ttft_steps)


# ---------------------------------------------------------------------------
# the ssm family: prefix replay refused in both packages
# ---------------------------------------------------------------------------
def test_ssm_prefix_replay_is_refused_by_both_packages():
    """Reduced mamba2-370m (SSD chunk 16): a retried request re-prefills
    prompt + emitted = 16 + 3 tokens, which the chunk does not divide; the
    JAX package refuses the length (an assertion in ``ssd_chunked``) and
    so does the port (``ValueError``).  Without retry the poison is a
    terminal eviction in both, and equal."""
    over = dict(remat="none", dtype="float32", n_layers=1, d_model=32,
                vocab=127)
    jcfg = get_arch("mamba2-370m").reduced().with_(**over)
    tcfg = t_get_arch("mamba2-370m").reduced().with_(**over)
    assert jcfg.ssm_chunk == tcfg.ssm_chunk == 16
    jp = tree_f32(j_init_params(jcfg, jax.random.PRNGKey(0)))
    slots = dict(n_slots=2, ctx_len=24, steps_per_launch=K)
    jsrv = jdist.SlotServer(jcfg, _mesh(), jdist.SlotConfig(**slots))
    tsrv = SlotServer(tcfg, SlotConfig(**slots), device="cpu")
    prompts = _prompts(2, 16)
    faults = ServeFaults(poisons=((1, 2),))
    want = jsrv.serve(jp, prompts, 6, faults=_jax_kw(
        dict(faults=faults))["faults"])
    got = tsrv.serve(port_params(jp), prompts, 6, faults=faults)
    _assert_same(got, want)
    assert got.evictions == {1: 2}
    retry = RetryPolicy(max_attempts=2, backoff_base=2)
    with pytest.raises(AssertionError):
        jsrv.serve(jp, prompts, 6, **_jax_kw(dict(faults=faults,
                                                  retry=retry)))
    with pytest.raises(ValueError, match="multiple of the chunk 16"):
        tsrv.serve(port_params(jp), prompts, 6, faults=faults, retry=retry)


# ---------------------------------------------------------------------------
# ServeJob and ServeBackend
# ---------------------------------------------------------------------------
def test_serve_job_resilience_fields_and_backend_surface():
    with pytest.raises(ValueError, match="max_retries"):
        ServeJob(max_retries=0)
    with pytest.raises(ValueError, match="max_retries"):
        ServeJob(max_retries=2)                    # needs the slot lane
    with pytest.raises(ValueError, match="queue_cap"):
        ServeJob(queue_cap=4)
    with pytest.raises(ValueError, match="queue_cap"):
        ServeJob(queue_cap=0, n_slots=2)
    with pytest.raises(ValueError, match="shed policy"):
        ServeJob(queue_cap=2, n_slots=2, shed_policy="nope")
    with pytest.raises(ValueError, match="drain_after"):
        ServeJob(drain_after=-1, n_slots=2)
    job = ServeJob(batch=2, prompt_len=4, arch_overrides=TINY_OVR,
                   n_slots=2, n_requests=3, max_retries=2, retry_backoff=2,
                   queue_cap=4, steps_per_launch=2)
    res = ServeBackend(device="cpu").run(ExperimentSpec(
        objective=job, T=5, seed=0,
        scenario="slot_poison:rid=1,step=2,every=0"))
    assert res.extra["attempts"] == {1: 1}
    assert res.extra["evictions"] == {}            # recovered via retry
    assert (res.x >= 0).all()
    assert res.extra["shed"] == {} and res.extra["drained"] == {}
    assert res.extra["resumed_from"] is None
    deg = res.extra["tau_report"]["degraded"]
    assert deg["attempts"] == {1: 1}
    assert "shed" in deg and "drained" in deg


def test_backend_lowers_the_scenario_and_knobs_as_jax_does():
    """The JAX ``ServeBackend`` and the port's on the same job and
    scenario: the same serve faults (fault horizon and RNG), the same
    degraded accounting and schedule (the params are each package's own,
    so only bookkeeping that no token steers is compared)."""
    import repro.api as japi

    kw = dict(batch=2, prompt_len=4, arch_overrides=TINY_OVR, n_slots=2,
              n_requests=6, max_retries=2, retry_backoff=2, queue_cap=2,
              shed_policy="drop-oldest", drain_after=14,
              arrival="bursty:gap=2", steps_per_launch=2)
    scen = "slot_poison:rid=1,step=3,every=4"
    got = run(ExperimentSpec(objective=ServeJob(**kw), T=5, seed=1,
                             scenario=scen), device="cpu")
    want = japi.run(japi.ExperimentSpec(objective=japi.ServeJob(**kw), T=5,
                                        seed=1, scenario=scen))
    for key in ("evictions", "timeouts", "shed", "drained", "attempts",
                "resumed_from", "decode_steps", "chunks"):
        assert got.extra[key] == want.extra[key], key
    np.testing.assert_array_equal(got.extra["ttft_steps"],
                                  want.extra["ttft_steps"])
    assert got.extra["tau_report"]["degraded"] == \
        want.extra["tau_report"]["degraded"]
    assert got.extra["attempts"]
    for f in ("workers", "assign_iters", "finish_times"):
        np.testing.assert_array_equal(getattr(got.schedule, f),
                                      getattr(want.schedule, f))


def test_tau_report_degraded_render():
    lock = run(ExperimentSpec(objective=ServeJob(
        batch=2, prompt_len=4, arch_overrides=TINY_OVR, n_slots=2,
        steps_per_launch=2), T=4), device="cpu")
    rep = tau_report(lock.schedule, "pure", concurrency=2,
                     evictions={0: 3}, timeouts={1: 2}, shed={2: 1},
                     drained={3: 4}, attempts={0: 2})
    assert rep["degraded"]["shed"] == {2: 1}
    assert rep["degraded"]["attempts"] == {0: 2}
    txt = render_report(rep)
    assert "1 shed" in txt and "1 drained" in txt
    assert "1 retried" in txt and "2 failed attempts" in txt
