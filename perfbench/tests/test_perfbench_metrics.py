"""The metric arithmetic on recorded fixtures: the interval union behind
the idle share, the gaps named by the host, the tails over all requests,
and each reader's answer when it finds nothing to read."""
from __future__ import annotations

import json
import os

import pytest

from perfbench_tiny import BENCH

from perfbench import registry, stats
from perfbench.trace import SHORT_GAPS, Trace, innermost

MS = 1_000_000                     # ns


def _config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def _traffic(name):
    return registry.traffic(name)


def _trace():
    """10 ms of window: two overlapping kernels on two streams (1–4 and
    3–5 ms), one at 7–8 ms; the host in ``copy`` across 5–7 ms and in
    ``launch`` from 8 ms on."""
    dev = [(1 * MS, 4 * MS, "k_a"), (3 * MS, 5 * MS, "k_b"),
           (7 * MS, 8 * MS, "k_a")]
    host = [(0, 10 * MS, "step"), (5 * MS, 7 * MS, "copy"),
            (8 * MS, 10 * MS, "launch")]
    return Trace(0, 10 * MS, dev, host)


def test_busy_time_is_the_union_not_the_sum():
    tr = _trace()
    assert tr.merged == [[1 * MS, 5 * MS], [7 * MS, 8 * MS]]
    assert tr.busy_s == pytest.approx(0.005)
    assert tr.device_seconds(lambda n: n == "k_a") == (pytest.approx(0.004),
                                                       2)


def test_idle_gaps_are_named_by_the_innermost_host_op():
    tr = _trace()
    assert tr.gaps() == [(0, 1 * MS), (5 * MS, 7 * MS), (8 * MS, 10 * MS)]
    by = dict(tr.idle_by_host())
    assert by == {"step": 1 * MS, "copy": 2 * MS, "launch": 2 * MS}
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(0.004)]
    assert len(b["idle_gaps"]) == 3


def test_short_gaps_are_lumped():
    tr = Trace(0, 10_000, [(0, 4_000, "k"), (5_000, 10_000, "k")])
    assert dict(tr.idle_by_host()) == {SHORT_GAPS: 1_000}


def test_innermost_skips_ended_events():
    evs = [(0, 100, "outer"), (10, 20, "inner"), (30, 40, "late")]
    assert innermost(evs, [15, 25, 35, 200]) == {15: "inner", 25: "outer",
                                                 35: "late"}


def test_p95_is_over_every_request():
    xs = list(range(1, 201))            # 200 requests
    assert stats.percentile(xs, 95) == pytest.approx(190.05)
    assert stats.percentile([5.0], 95) == 5.0


def _serve_record(**over):
    serves = [{"requests": 3, "failed": 0, "tokens": 192, "decode_steps": 80,
               "chunk_device_ms": 400.0, "ttft_s": [0.1, 0.2, 0.3],
               "tpot_s": [0.01, 0.02, 0.03], "wall_s": 2.0},
              {"requests": 2, "failed": 0, "tokens": 128, "decode_steps": 72,
               "chunk_device_ms": 360.0, "ttft_s": [0.4, 0.5],
               "tpot_s": [0.04, 0.05], "wall_s": 2.0}]
    rec = {"serves": serves, "window_s": 4.0,
           "config": _config("qwen2-0.5b"),
           "traffic": _traffic("slots16-p512-o64"), "setup_s": 9.0}
    rec.update(over)
    return rec


def test_serving_readers():
    rec = _serve_record()
    read = lambda m: registry.metric(m).read(rec)
    assert read("serve_tokens_per_s") == pytest.approx(320 / 4.0)
    assert read("ttft_p95_ms.hostbound") == pytest.approx(
        stats.percentile([0.1, 0.2, 0.3, 0.4, 0.5], 95) * 1e3)
    assert read("tpot_p95_ms.hostbound") == pytest.approx(48.0)
    assert read("decode_device_ms_per_step") == pytest.approx(760 / 152)
    assert read("setup_s") == 9.0
    for m in ("flash_roofline", "ssd_roofline", "idle_share.serve"):
        assert read(m) is None          # nothing traced: nothing read


def test_serving_traced_readers():
    r = _config("qwen2-0.5b")["run"]
    lo, hi = _traffic("slots16-p512-o64")["traced_steps"][:2]
    # 24 flash calls (one admission) of 0.1 ms, the device busy 1 s over
    # the traced steps
    dev = [(i * 10 * MS, i * 10 * MS + MS // 10, "flash_fwd_hopper")
           for i in range(24)] + [(300 * MS, 300 * MS + 1_000 * MS - 24 * MS
                                   // 10, "other")]
    rec = _serve_record(trace=Trace(0, 2_000 * MS, dev))
    from perfbench.costs import kernels, peaks
    f, b = kernels.flash_cost(1, 512, 512, r["n_heads"], r["n_kv_heads"],
                              r["d_head"])
    want = 100 * 24 * peaks.bound_s(f, b) / (24 * 1e-4)
    assert registry.metric("flash_roofline").read(rec) == pytest.approx(want)
    assert registry.metric("ssd_roofline").read(rec) is None   # no SSD
    busy_step = 1.0 / (hi - lo)
    assert registry.metric("idle_share.serve").read(rec) == pytest.approx(
        100 * (1 - busy_step * 152 / 4.0))
    dev = dev[:23] + dev[24:]           # 23 calls: not whole admissions
    rec = _serve_record(trace=Trace(0, 2_000 * MS, dev))
    assert registry.metric("flash_roofline").read(rec) is None


def test_training_readers():
    r = _config("qwen2-0.5b")["run"]
    dev = [(0, 100 * MS, "adam_kernel<bf16>"), (100 * MS, 500 * MS, "gemm")]
    rec = {"rounds": 200, "global_batch": 8, "seq_len": 512,
           "window_s": 40.0, "traced_rounds": 4,
           "pool_elements": {"bfloat16": 494_032_768},
           "trace": Trace(0, 1_000 * MS, dev),
           "config": _config("qwen2-0.5b")}
    read = lambda m: registry.metric(m).read(rec)
    assert read("train_tokens_per_s") == pytest.approx(200 * 4096 / 40.0)
    from perfbench.costs import flops, peaks
    assert read("train_mfu") == pytest.approx(
        100 * flops.train_round(r, 8, 512) * 200 / 40.0 / peaks.BF16_FLOPS)
    assert read("round_device_ms") == pytest.approx(125.0)
    assert read("idle_share.train") == pytest.approx(
        100 * (1 - 0.125 * 200 / 40.0))
    assert read("update_roofline") == pytest.approx(
        100 * 494_032_768 * 26 / peaks.HBM_BYTES_PER_S / 0.1)
