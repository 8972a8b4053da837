"""The port's launch tier: the op-level cost model, the dry-run on ``meta``,
the roofline and the hill-climb harness.

``op_cost`` is held to hand counts (products, eager bytes with views
skipped, peak live bytes, a kernel counted once by its formula, a
collective's operand bytes); ``model_flops`` and ``analyze_record`` to the
JAX package's (exactly, and up to the ratio of the H100 and TPU v5e
constants); the dry-run traces the reduced train, prefill and decode steps
of each family on ``meta``, and its tally must equal the same step's tally
run on the CPU (kernels on, so each counts once by its formula).  The JAX
``hlo_cost`` is no yardstick here: XLA:CPU lowers most small products to
fusions it does not count as dots.  A full-width dry-run runs in a
subprocess (meta allocates nothing, so it is cheap) and the roofline reads
its record.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
from repro.launch import mesh as JMESH
from repro.launch import roofline as JR

from repro_torch.configs import InputShape, get_arch, smoke_shape
from repro_torch.distributed.sharding import SEQ_PARALLEL_RULES
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_mask
from repro_torch.launch import dryrun, hillclimb, mesh, op_cost, roofline
from repro_torch.models import model as TM
from repro_torch.models.specs import meta_tree
from repro_torch.tree import tree_leaves_with_path

ROOT = Path(__file__).resolve().parents[1]
F32 = torch.float32


def test_h100_constants():
    assert (mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_F32, mesh.HBM_BW,
            mesh.HBM_BYTES, mesh.NVLINK_BW) == (989e12, 67e12, 3.35e12,
                                                80e9, 450e9)


def test_host_mesh_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = mesh.make_host_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.axis_names == (
        "data", "model")
    assert mesh.mesh_devices(m) == 1


# ---------------------------------------------------------------------------
# roofline against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_model_flops_match_jax(arch):
    for shape in JSHAPES:
        assert roofline.model_flops(arch, shape) == \
            JR.model_flops(arch, shape), shape


def test_analyze_record_matches_jax_up_to_the_constants():
    counts = {"dot_flops": 1.0e15, "hbm_bytes": 2.0e12,
              "collective_bytes": 3.0e10, "collective_breakdown": {}}
    rec = {"arch": "qwen2-0.5b", "shape": "train_4k", "family": "dense",
           "kind": "train", "memory": {"peak_bytes_est": 5.0e9},
           "hlo_cost": counts, "op_cost": counts}
    want, got = JR.analyze_record(rec, 4), roofline.analyze_record(rec, 4)
    ratio = {"compute_s": JMESH.PEAK_FLOPS_BF16 / mesh.PEAK_FLOPS_BF16,
             "memory_s": JMESH.HBM_BW / mesh.HBM_BW,
             "collective_s": JMESH.ICI_BW / mesh.NVLINK_BW}
    for key, r in ratio.items():
        assert got[key] == pytest.approx(want[key] * r, rel=1e-12), key
    for key in ("model_flops", "useful_ratio", "mem_gb_per_dev", "arch",
                "shape", "family", "dominant"):
        assert got[key] == want[key], key
    assert got["op_flops_total"] == want["hlo_flops_total"]
    assert got["bound_s"] == got["compute_s"]
    assert got["suggestion"] == want["suggestion"]


# ---------------------------------------------------------------------------
# op_cost against hand counts
# ---------------------------------------------------------------------------

def test_two_matmuls_count_2mnk_each():
    M, K, N, P = 8, 16, 32, 4
    a, b, c = torch.randn(M, K), torch.randn(K, N), torch.randn(N, P)
    cost = op_cost.analyze(lambda a, b, c: (a @ b) @ c, a, b, c)
    assert cost.dot_flops == 2 * M * N * K + 2 * M * P * N
    assert cost.ops["aten.mm"][:2] == [2, cost.dot_flops]
    bias = torch.randn(N)
    cost = op_cost.analyze(torch.addmm, bias, a, b)
    assert cost.dot_flops == 2 * M * N * K


def test_bytes_of_an_op_chain_skip_views():
    """mul reads and writes 16·8 f32; the views move nothing; the sum
    reads the transposed view and writes a scalar; an in-place add reads
    its operand once (its result is the operand); copy_ reads the source
    and writes the destination."""
    x = torch.randn(8, 16)
    n = x.numel() * 4

    def chain(x):
        z = x.view(16, 8) * 2.0
        s = z.t().unsqueeze(0).sum()
        z.add_(1.0)
        x.copy_(z.view(8, 16))
        return s
    cost = op_cost.analyze(chain, x)
    assert cost.hbm_bytes == 2 * n + (n + 4) + n + 2 * n
    for view in ("aten.view", "aten.t", "aten.unsqueeze"):
        assert cost.ops[view][2] == 0
    assert cost.n_ops == 8                 # two views, t, unsqueeze
    assert cost.collective_bytes == 0 and cost.as_dict()["n_while"] == 0


def test_peak_live_bytes_with_a_freed_intermediate():
    x = torch.randn(1 << 18)                 # 1 MiB
    mib = 1 << 20

    def seq(x):
        a = x * 2.0                          # 2 MiB live
        b = a + 1.0                          # 3 MiB: the peak
        del a                                # 2 MiB
        c = b * 3.0                          # 3 MiB again
        del b
        return c.sum()
    cost = op_cost.analyze(seq, x)
    assert cost.argument_bytes == mib
    assert cost.peak_live_bytes == 3 * mib
    # a view shares its base's storage: no new live bytes
    cost = op_cost.analyze(lambda x: x.view(512, 512).t().contiguous(), x)
    assert cost.peak_live_bytes == 2 * mib


def test_kernel_region_counts_the_cpu_plain_flash_once():
    B, S, H, KV, D = 2, 48, 4, 2, 32
    q = torch.randn(B, S, H, D)
    k, v = torch.randn(B, S, KV, D), torch.randn(B, S, KV, D)
    cost = op_cost.analyze(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=True, window=20),
        q, k, v)
    pairs = int(attention_mask(S, S, True, 20).sum())
    flops = 4 * D * pairs * B * H
    nbytes = 2 * (q.numel() + k.numel()) * 4
    assert cost.kernels == {"flash_attention": [1, flops, nbytes]}
    assert (cost.dot_flops, cost.hbm_bytes, cost.n_ops) == (flops, nbytes, 1)
    assert list(cost.ops) == ["kernel.flash_attention"]
    # the plain version's temporaries are not live; its output is
    assert cost.peak_live_bytes == cost.argument_bytes + q.numel() * 4


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (64, 64, True, None), (64, 64, False, None), (64, 64, True, 16),
    (64, 64, False, 16), (40, 64, True, None), (64, 40, True, 7),
    (1, 1, True, 1), (100, 30, False, 1000)])
def test_visible_pairs_is_the_mask_count(Sq, Sk, causal, window):
    assert op_cost.visible_pairs(Sq, Sk, causal, window) == \
        int(attention_mask(Sq, Sk, causal, window).sum())


def test_update_formula_gives_the_kernel_table_bound():
    """fused_adam_delayed over qwen2-0.5b's 494,032,768 bf16 elements: 26
    bytes an element, the 3.8343 ms bytes bound of the kernel table."""
    p = torch.empty(494_032_768, dtype=torch.bfloat16, device="meta")
    ops_, nbytes = op_cost.update_cost("fused_adam_delayed", p, p)
    assert nbytes == 26 * p.numel() and ops_ == 18 * p.numel()
    ms, by = op_cost.bound_ms(ops_, nbytes, mesh.PEAK_FLOPS_F32)
    assert by == "bytes" and round(ms, 4) == 3.8343
    per = {k: op_cost.update_bytes_per_elem(k, 2, 2)
           for k in op_cost.UPDATE_OPS}
    assert per == {"async_update": 10, "sgd_step": 6,
                   "sgd_momentum_step": 14, "sgd_momentum_delayed": 18,
                   "fused_adam": 22, "fused_adam_delayed": 26}


def test_update_kernels_on_meta_take_the_plain_route_in_place():
    n = 1000
    t = {k: torch.empty(n, dtype=torch.bfloat16 if k in ("p", "gb", "g")
                        else F32, device="meta")
         for k in ("p", "m", "v", "gb", "g")}
    scal = torch.empty(6, dtype=F32, device="meta")
    assert ops._route("fused_adam_delayed", t["p"]) == "plain"
    out = ops.fused_adam_delayed(t["p"], t["m"], t["v"], t["gb"], t["g"],
                                 scal)
    assert all(a is b for a, b in zip(out, (t["p"], t["m"], t["v"],
                                            t["gb"])))
    cost = op_cost.analyze(ops.fused_adam_delayed, t["p"], t["m"], t["v"],
                           t["gb"], t["g"], scal)
    assert cost.kernels == {"fused_adam_delayed": [1, 18 * n, 26 * n]}
    assert cost.dot_flops == 0 and cost.hbm_bytes == 26 * n
    assert cost.peak_live_bytes == cost.argument_bytes


def test_collective_bytes_of_functional_collectives():
    dist = pytest.importorskip("torch.distributed")
    funcol = pytest.importorskip("torch.distributed._functional_collectives")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(backend="fake", rank=0, world_size=2,
                            store=FakeStore())
    try:
        t = torch.ones(4, 8)
        cost = op_cost.analyze(
            lambda t: funcol.all_reduce(t, "sum", dist.group.WORLD) + 1, t)
    finally:
        dist.destroy_process_group()
    assert cost.collective_bytes == 128
    assert cost.collective_breakdown == {"all-reduce": 128}


def test_meta_tree_keeps_the_paths():
    specs = TM.param_specs(get_arch("qwen2-0.5b").reduced())
    tree = meta_tree(specs)
    got, want = tree_leaves_with_path(tree), tree_leaves_with_path(specs)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, t), (_, s) in zip(got, want):
        assert t.is_meta and tuple(t.shape) == tuple(s.shape)
        assert str(t.dtype) == f"torch.{s.dtype}"


# ---------------------------------------------------------------------------
# the dry-run: every family's reduced steps on meta ≡ on the CPU
# ---------------------------------------------------------------------------

FAMILY_ARCH = {"dense": "qwen2-0.5b", "ssm": "mamba2-370m",
               "hybrid": "zamba2-7b", "moe": "deepseek-moe-16b",
               "audio": "seamless-m4t-large-v2", "vlm": "pixtral-12b"}


def _kernels_on(cfg):
    return cfg.with_(use_flash_attention=cfg.family != "ssm",
                     use_ssd_kernel=cfg.family in ("ssm", "hybrid"))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_run_one_traces_each_family_on_meta(family, kind):
    """The record's keys and counts, then the meta tally against the same
    step run on the CPU (trains pooled; serves with the kernels on, which
    the prefill launches once per layer): equal flops, bytes, peak and
    kernel rows."""
    cfg = get_arch(FAMILY_ARCH[family]).reduced()
    if kind == "prefill":
        cfg = _kernels_on(cfg)
    shape = smoke_shape(kind)
    kw = dict(update_impl="pallas_pooled" if kind == "train"
              else "reference", n_groups=2)
    rec = dryrun.run_one(cfg, shape, verbose=False, **kw)
    assert rec["ok"], rec.get("traceback")
    assert (rec["mesh"], rec["n_devices"], rec["family"], rec["kind"]) == (
        "h100x1", 1, family, kind)
    oc = rec["op_cost"]
    assert oc["dot_flops"] > 0 and rec["memory"]["peak_bytes_est"] > 0
    assert rec["memory"]["peak_bytes_est"] >= rec["memory"]["argument_bytes"]
    assert rec["fits"] and rec["trace_s"] >= 0
    assert rec["analytic_state_bytes"] >= max(
        rec["sharded_state_bytes"].values())
    fn, args = dryrun.build_step(cfg, shape, "cpu", **kw)
    cpu = op_cost.analyze(fn, *args)
    assert (cpu.dot_flops, cpu.hbm_bytes, cpu.peak_live_bytes) == (
        oc["dot_flops"], oc["hbm_bytes"], rec["memory"]["peak_bytes_est"])
    assert {k: [v["launches"], v["flops"], v["bytes"]]
            for k, v in oc["kernels"].items()} == cpu.kernels
    if kind == "train":
        assert cpu.kernels["fused_adam_delayed"][0] == len(
            args[0]["pools"])
    elif kind == "prefill" and family != "ssm":
        assert cpu.kernels["flash_attention"][0] > 0


def test_plain_kernels_return_the_kernels_layout(monkeypatch):
    """Flash's and SSD's plain versions hand back contiguous outputs, as
    the CUDA kernels do, so the ops that follow them (a reshape copies a
    strided tensor) are the same on every route and the meta trace counts
    the card's step."""
    from repro_torch.kernels import flash_attention as FA, ssd_chunk as SSD
    seen = []
    for mod, name in ((SSD, "ssd_chunk_plain"), (FA, "flash_attention_plain")):
        def recording(*a, _fn=getattr(mod, name), **k):
            out = _fn(*a, **k)
            seen.extend(o.is_contiguous() for o in
                        (out if isinstance(out, tuple) else (out,)))
            return out
        monkeypatch.setattr(mod, name, recording)
    cfg = _kernels_on(get_arch("zamba2-7b").reduced())
    fn, args = dryrun.build_step(cfg, smoke_shape("prefill"), "cpu")
    fn(*args)
    assert len(seen) == 6 and all(seen)


def test_dryrun_subprocess_end_to_end(tmp_path):
    """Trace one full-width step through the CLI; the roofline reads it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads((tmp_path / "qwen2-0.5b_decode_32k_h100x1.json")
                     .read_text())
    assert rec["ok"] and rec["n_devices"] == 1
    assert rec["op_cost"]["dot_flops"] > 0
    assert 0 < rec["memory"]["peak_bytes_est"] < mesh.HBM_BYTES
    assert rec["fits"]
    rows = roofline.load_table(str(tmp_path))
    assert len(rows) == 1 and "error" not in rows[0]
    r = rows[0]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                               r["collective_s"])
    assert "| qwen2-0.5b | decode_32k |" in roofline.render_markdown(rows)


@pytest.mark.parametrize("flag", ["--multi-pod", "--both-meshes"])
def test_dryrun_refuses_the_mesh_flags(flag, capsys, tmp_path):
    """The mesh flags are refused no more: each traces rank 0 of its
    production meshes in place of one card (``--multi-pod`` the 2x32x8
    mesh, ``--both-meshes`` both) and writes one record per mesh."""
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", flag,
                 "--out", str(tmp_path)])
    meshes = {"--multi-pod": ["2x32x8"], "--both-meshes": ["32x8",
                                                           "2x32x8"]}[flag]
    assert sorted(p.name for p in tmp_path.glob("*.json")) == sorted(
        f"qwen2-0.5b_decode_32k_{m}.json" for m in meshes)
    assert f"{len(meshes)}/{len(meshes)} combinations traced OK" in \
        capsys.readouterr().out


def test_hillclimb_rules_variant_moves_only_the_sharded_state(capsys):
    """The hill-climb traces rank 0 of ``32x8``, as the JAX one lowers its
    production mesh, so a Rules variant moves the traced terms (on one
    card it moved only the sharded state, which the name recalls): on
    reduced qwen2-0.5b, whose 4 heads do not divide the model axis of 8,
    ``seq_parallel`` (and ``auto``, which picks it) lowers ``compute_s``
    and ``mem_gb`` against ``baseline``; with 8 heads ``auto`` keeps the
    default rules and agrees with ``baseline``."""
    cfg = get_arch("qwen2-0.5b").reduced()
    shape = InputShape("hc_prefill", 64, 32, "prefill")
    res = hillclimb.compare(cfg, shape, [
        ("baseline", None, {}), ("seq_parallel", SEQ_PARALLEL_RULES, {}),
        ("auto", None, {"auto": True})])
    base = res["baseline"]
    for name in ("seq_parallel", "auto"):
        assert res[name]["ok"]
        for key in ("compute_s", "mem_gb"):
            assert res[name][key] < base[key], (name, key)
    for key in ("compute_s", "memory_s", "collective_s", "mem_gb"):
        assert res["auto"][key] == res["seq_parallel"][key], key
    heads8 = cfg.with_(n_heads=8, n_kv_heads=8)
    res = hillclimb.compare(heads8, shape, [("baseline", None, {}),
                                            ("auto", None, {"auto": True})])
    for key in ("compute_s", "memory_s", "collective_s", "mem_gb"):
        assert res["auto"][key] == res["baseline"][key], key
    assert "state/dev=" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        hillclimb.main(["--pair", "grok_train", "--variants", "nope"])
    assert exc.value.code == 2
    assert set(hillclimb.PAIRS) == {"grok_train", "deepseek_train",
                                    "qwen2_prefill"}


def test_dryrun_record_keys_match_jax():
    """The keys the JAX record and the port's share mean the same."""
    rec = dryrun.run_one(get_arch("mamba2-370m").reduced(),
                         smoke_shape("decode"), verbose=False)
    for key in ("arch", "shape", "mesh", "n_devices", "family", "kind",
                "sliding_window", "ok", "memory", "analytic_state_bytes"):
        assert key in rec
    assert set(rec["op_cost"]) >= {"dot_flops", "hbm_bytes",
                                   "collective_bytes", "collective_breakdown",
                                   "n_while", "unknown_trip_loops"}
    assert dataclasses.asdict(dryrun.arch_for_shape(
        get_arch("qwen2-0.5b"), JSHAPES["long_500k"])
    )["sliding_window"] == dryrun.LONG_WINDOW
