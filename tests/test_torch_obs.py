"""`repro_torch.obs` and its threading through the port, against JAX.

The obs modules are copies of the JAX package's (framework-free); the
port's ``CompileWatch`` counts CUDA graph captures where JAX's counts jit
signatures.  Held here: the copies' primitives and schema (the metrics
JSONL, and the Chrome trace the port's schema also validates); a traced
training run, scan and eager, bit-identical to an untraced one, with the
trace telling its dispatch story (launch spans, host syncs, one
``guard_skip`` instant per skipped round); the snapshotter's spans; the
backend summary through ``RunResult`` JSON; a slot-server serve on the
CPU emitting the same event names and counts as the JAX ``SlotServer`` on
the same serve (clean, and with a poison, retry and drain), apart from
JAX's ``compile`` instants: on the CPU the port captures nothing; and the
capture watch's steady-state contract.
"""
import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                     # noqa: E402
from jax.sharding import Mesh                                  # noqa: E402

from repro.configs import get_arch                             # noqa: E402
from repro.distributed import RetryPolicy as JRetryPolicy      # noqa: E402
from repro.distributed import SlotConfig as JSlotConfig        # noqa: E402
from repro.distributed import SlotServer as JSlotServer        # noqa: E402
from repro.faults import ServeFaults as JServeFaults           # noqa: E402
from repro.models import init_params as j_init_params          # noqa: E402
from repro.obs import Recorder as JRecorder                    # noqa: E402
from repro_torch.api import (ExperimentSpec, RunResult,        # noqa: E402
                             ServeBackend, ServeJob, SimulatorBackend,
                             TrainerBackend, TrainJob)
from repro_torch.checkpoint import AsyncSnapshotter            # noqa: E402
from repro_torch.configs import get_arch as t_get_arch         # noqa: E402
from repro_torch.distributed import (RetryPolicy, SlotConfig,  # noqa: E402
                                     SlotServer)
from repro_torch.faults import ServeFaults                     # noqa: E402
from repro_torch.obs import (METRICS_SCHEMA_VERSION,           # noqa: E402
                             CompileWatch, Recorder, RetraceError,
                             SchemaError, Tracer, render_summary,
                             validate_chrome_trace, validate_metrics_log)
from repro_torch.runtime import (PlanExecutor, compile_plan)  # noqa: E402
from repro_torch.tree import tree_leaves                       # noqa: E402
from torch_parity import port_params, tree_f32                 # noqa: E402

FAULTED = "nan_grad:k=2,every=2,span=1;sparsify:frac=0.5"


def _spec(T=8, scenario=FAULTED, guards=True, **kw):
    job = TrainJob(global_batch=8, seq_len=16, update_impl="pallas",
                   guards=guards, arch_overrides=(("n_layers", 1),
                                                  ("vocab", 97)))
    base = dict(scheduler="shuffled", timing="poisson:slow=6", T=T,
                n_workers=4, seed=0, scenario=scenario, stepsize=3e-3,
                rounds_per_launch=3)
    return ExperimentSpec(objective=job, **{**base, **kw})


def _events(rec):
    return rec.tracer.chrome_trace()["traceEvents"]


# ---------------------------------------------------------------------------
# the copied modules
# ---------------------------------------------------------------------------
def test_copied_modules_keep_the_jax_primitives(tmp_path):
    tr = Tracer()
    with tr.span("launch", "executor", lo=0, hi=4):
        pass
    tr.span_at("request", "slot0", 0, 3_000_000, rid=1)
    tr.instant("guard_skip", lane="faults", round=np.int64(3))
    tr.gauge("gscale", 0.5, lane="faults")
    tr.count("rounds", 8)
    tr.hist("ttft_steps", 1.0)
    tr.hist("ttft_steps", 3.0)
    phases = tr.phase_table()
    assert phases["launch"]["count"] == 1
    assert phases["request"]["total_s"] == pytest.approx(0.003)
    assert tr.counters() == {"rounds": 8}
    assert tr.hist_summaries()["ttft_steps"]["mean"] == pytest.approx(2.0)
    doc = tr.chrome_trace()
    assert validate_chrome_trace(doc) == {"M": 4, "X": 2, "i": 1, "C": 1}
    assert {e["args"]["name"] for e in doc["traceEvents"]
            if e["name"] == "process_name"} == {"repro_torch"}
    json.dumps(doc)                             # numpy args degrade
    path = str(tmp_path / "m.jsonl")
    tr.export_metrics(path)
    assert validate_metrics_log(path) == {"header": 1, "gauge": 1,
                                          "counter": 1, "hist": 1}
    assert json.loads(open(path).readline())["v"] == METRICS_SCHEMA_VERSION


@pytest.mark.parametrize("mutate", [
    lambda d: d.pop("displayTimeUnit"),
    lambda d: d["traceEvents"].append({"ph": "B", "name": "x"}),
    lambda d: d["traceEvents"][-1].update(dur=-1.0),
    lambda d: d["traceEvents"][-1].update(ts="0"),
    lambda d: d["traceEvents"].append(dict(d["traceEvents"][0])),
    lambda d: d["traceEvents"].append({"ph": "i", "name": "x", "cat": "c",
                                       "pid": 0, "tid": 99, "ts": 0.0,
                                       "s": "t"}),
], ids=["envelope", "phase", "duration", "type", "two_processes",
        "unnamed_lane"])
def test_chrome_trace_validator_rejects(mutate):
    tr = Tracer()
    with tr.span("launch", "executor"):
        pass
    doc = tr.chrome_trace()
    validate_chrome_trace(doc)
    mutate(doc)
    with pytest.raises(SchemaError):
        validate_chrome_trace(doc)


def test_compile_watch_counts_captures_and_holds_steady():
    rec = Recorder()
    w = CompileWatch(rec)
    w.register("chunk")
    assert w.counts() == {"chunk": 0}
    with pytest.raises(RetraceError, match="before mark_steady"):
        w.check_steady()
    w.captured("chunk")
    w.captured("grid[7,chunk]")
    assert w.counts() == {"chunk": 1, "grid[7,chunk]": 1}
    w.mark_steady()
    w.check_steady()                            # nothing new: quiet
    w.captured("chunk")
    with pytest.raises(RetraceError, match=r"chunk: 1 -> 2"):
        w.check_steady()
    compiles = [e for e in _events(rec) if e["name"] == "compile"]
    assert [e["args"]["fn"] for e in compiles] == ["chunk", "grid[7,chunk]",
                                                   "chunk"]
    assert rec.tracer.counters()["compiles"] == 3


def test_simulator_backend_watch_counts_no_capture_on_the_cpu():
    from repro_torch.objectives import LogRegProblem, make_libsvm_like

    A, b = make_libsvm_like("w7a", n=4, seed=0)
    rec = Recorder()
    res = SimulatorBackend(device="cpu", recorder=rec).run(ExperimentSpec(
        objective=LogRegProblem(A, b, lam=0.1, device="cpu"), T=50,
        stepsize=(0.01, 0.001), log_every=10))
    assert res.extra["runtime"] == "eager"
    assert res.extra["compile_counts"] == {}    # the eager loop captures
    assert res.extra["obs"]["schema_version"] == METRICS_SCHEMA_VERSION


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("runtime", ["scan", "eager"])
def test_traced_training_run_is_bit_identical(runtime, tmp_path):
    plain = TrainerBackend("cpu", runtime=runtime).run(_spec())
    rec = Recorder()
    traced = TrainerBackend("cpu", runtime=runtime, recorder=rec).run(
        _spec())
    np.testing.assert_array_equal(traced.losses, plain.losses)
    np.testing.assert_array_equal(traced.grad_norms, plain.grad_norms)
    for a, b in zip(tree_leaves(traced.x), tree_leaves(plain.x)):
        assert torch.equal(a, b)
    c = rec.tracer.counters()
    assert c["rounds"] == 8
    assert c["launches"] == traced.extra["launches"]
    assert c["host_syncs"] == traced.extra["host_syncs"]
    phases = rec.tracer.phase_table()
    assert phases["launch"]["count"] == traced.extra["launches"]
    skipped = [m["skipped"] for m in traced.extra["metrics"]]
    skips = [e for e in _events(rec) if e["name"] == "guard_skip"]
    assert sum(skipped) >= 1 and len(skips) == sum(skipped)
    assert [e["args"]["round"] for e in skips] == \
        [q for q, s in enumerate(skipped) if s]
    gauges = [e for e in _events(rec) if e["ph"] == "C"]
    assert len(gauges) == sum(m["gscale"] != 1.0 and not m["skipped"]
                              for m in traced.extra["metrics"])
    counts = validate_chrome_trace(json.load(open(
        rec.export_chrome(str(tmp_path / "t.json")))))
    assert counts["X"] == sum(p["count"] for p in phases.values())
    validate_metrics_log(rec.export_metrics(str(tmp_path / "m.jsonl")))


def test_backend_summary_survives_runresult_json():
    rec = Recorder()
    res = TrainerBackend("cpu", recorder=rec).run(_spec(T=6))
    obs = res.extra["obs"]
    assert obs["schema_version"] == METRICS_SCHEMA_VERSION
    assert obs["rounds"] == 6 and obs["counters"]["rounds"] == 6
    restored = RunResult.from_json(res.to_json())
    assert restored.extra["obs"]["counters"] == obs["counters"]
    text = render_summary(restored.extra["obs"], trace=restored.trace)
    assert "launch" in text and "rounds/s" in text and "tau_max" in text
    assert TrainerBackend("cpu").run(_spec(T=2)).extra["obs"] is None


def test_snapshot_spans(tmp_path):
    spec = _spec(T=8, scenario=None, guards=False)
    tr_backend = TrainerBackend("cpu")
    tr, cfg, groups = tr_backend._make_trainer(spec, spec.objective, 3e-3,
                                               False, torch.device("cpu"))
    _, schedule = TrainerBackend.masks_for(spec, groups)
    plan = compile_plan(schedule, spec.objective, rounds=8, n_groups=groups)
    rec = Recorder()
    snap = AsyncSnapshotter(str(tmp_path / "s"), 4)
    res = PlanExecutor(tr, plan, recorder=rec).run_scan(
        tr.init_state(0), rounds_per_launch=4, snapshot=snap)
    assert res.stats.snapshots == 2 and snap.recorder is rec
    c = rec.tracer.counters()
    assert c["snapshots"] == 2 and c["snapshot_writes"] == 2
    phases = rec.tracer.phase_table()
    for name in ("snapshot_offer", "snapshot_copy", "snapshot_finalise"):
        assert phases[name]["count"] == 2, name


def test_serve_backend_lock_step_obs():
    rec = Recorder()
    job = ServeJob(batch=2, prompt_len=4, arch_overrides=(
        ("n_layers", 1), ("d_model", 8), ("n_heads", 1), ("n_kv_heads", 1),
        ("d_ff", 16), ("vocab", 127)))
    res = ServeBackend(device="cpu", recorder=rec).run(
        ExperimentSpec(objective=job, T=4))
    plain = ServeBackend(device="cpu").run(ExperimentSpec(objective=job,
                                                          T=4))
    np.testing.assert_array_equal(res.x, plain.x)
    assert set(res.extra["obs"]["phases"]) == {"prefill", "decode"}
    assert plain.extra["obs"] is None


# ---------------------------------------------------------------------------
# the slot server against the JAX SlotServer
# ---------------------------------------------------------------------------
TINY = dict(n_layers=1, d_model=8, n_heads=1, n_kv_heads=1, d_ff=16,
            vocab=127, remat="none", dtype="float32")
SLOTS = dict(n_slots=2, ctx_len=24, steps_per_launch=2)


def _story(rec):
    """What a trace says, as counts: spans, instants and gauges by name
    (JAX's ``compile`` instants aside), counters (``compiles`` aside) and
    histogram sizes."""
    ev = Counter((e["ph"], e["name"]) for e in _events(rec)
                 if e["ph"] != "M" and e["name"] != "compile")
    counters = {k: v for k, v in rec.tracer.counters().items()
                if k != "compiles"}
    hists = {k: h["count"] for k, h in rec.tracer.hist_summaries().items()}
    lanes = {e["args"]["name"] for e in _events(rec)
             if e["name"] == "thread_name"} - {"compile"}
    return ev, counters, hists, lanes


@pytest.fixture(scope="module")
def slot_world():
    jcfg = get_arch("qwen2-0.5b").reduced().with_(**TINY)
    tcfg = t_get_arch("qwen2-0.5b").reduced().with_(**TINY)
    jp = tree_f32(j_init_params(jcfg, jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(0).integers(0, 127, (5, 5)).astype(
        np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=port_params(jp),
                prompts=prompts, mesh=Mesh(np.array(jax.devices()[:1])
                                           .reshape(1, 1), ("data", "model")))


@pytest.mark.parametrize("resilient", [False, True],
                         ids=["clean", "poison_retry_drain"])
def test_slot_server_trace_matches_jax(slot_world, resilient, tmp_path):
    w = slot_world
    arrivals = np.array([0, 0, 1, 3, 6])
    jkw, tkw = {}, {}
    if resilient:
        jkw = dict(retry=JRetryPolicy(2, backoff_base=2),
                   faults=JServeFaults(poisons=((1, 3),)), drain_after=10)
        tkw = dict(retry=RetryPolicy(2, backoff_base=2),
                   faults=ServeFaults(poisons=((1, 3),)), drain_after=10)
    jrec, trec = JRecorder(), Recorder()
    want = JSlotServer(w["jcfg"], w["mesh"], JSlotConfig(**SLOTS),
                       recorder=jrec).serve(
        w["jp"], w["prompts"], 6, admission="shuffled", arrivals=arrivals,
        **jkw)
    srv = SlotServer(w["tcfg"], SlotConfig(**SLOTS), device="cpu",
                     recorder=trec)
    got = srv.serve(w["tp"], w["prompts"], 6, admission="shuffled",
                    arrivals=arrivals, **tkw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.evictions == want.evictions and got.drained == want.drained
    g_ev, g_c, g_h, g_l = _story(trec)
    w_ev, w_c, w_h, w_l = _story(jrec)
    assert g_ev == w_ev
    assert g_c == w_c and g_h == w_h and g_l == w_l
    # one admit span per admission, retries' re-admissions included
    assert g_ev[("X", "admit")] == g_ev[("X", "prefill")] >= \
        g_c["completions"]
    if resilient:
        assert g_c["retries"] >= 1 and g_c["evictions"] >= 1
    assert srv.compile_counts() == {"chunk": 0}  # the CPU route: eager
    validate_chrome_trace(json.load(open(trec.export_chrome(
        str(tmp_path / "s.json")))))
    validate_metrics_log(trec.export_metrics(str(tmp_path / "s.jsonl")))
    plain = SlotServer(w["tcfg"], SlotConfig(**SLOTS), device="cpu").serve(
        w["tp"], w["prompts"], 6, admission="shuffled", arrivals=arrivals,
        **tkw)
    np.testing.assert_array_equal(plain.tokens, got.tokens)   # obs inert
