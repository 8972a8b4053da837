"""The port's data-parallel trainer over R ranks against itself on one process,
and what the ranks hold, send and save.

Ranks are spawned over gloo (``tests/torch_dp.py``) on three meshes: ``data
2``, ``data 4`` and ``pod 2 × data 2`` (one world of four ranks runs the
last two in turn). On each, reduced qwen2-0.5b in f32
(the port's params cast to f32), T 4, on the pooled route (the update
kernels' plain versions) and the per-leaf reference route: the curves within
rtol 1e-5 of the one-process port (another summation order) and the final
params, m, v and gbuf within 1e-4 relative L2 per leaf, the attention key
bias's within 1e-2: the per-leaf bounds of ``tests/test_torch_faults.py``
(the q and k biases' gradients are sums that nearly cancel, so a summation
order moves them by 2–3e-5 relative, and Adam turns the k bias's rounding
into lr-sized steps). On ``data 2`` also: the backend under guards and
``FAULT_SCENARIO`` (chip_smoke.py's faults phase; f32 params and
activations) skips the same rounds as one process, its curve within the
trainer-curve rtol 5e-3 of ``tests/test_torch_faults.py``'s backend test
(the sparsifier's kept sets differ where rounding straddles the threshold:
1.3e-4 apart by round 14); the pooled update kernel launches once per rank
per dtype pool a round, on the rank's row, and each rank keeps only its row
of m, v and gbuf; a round's ``collective_bytes`` in ``launch/op_cost.py``'s
tally equals the hand count; a ranked checkpoint holds the JAX
checkpointer's arrays (the gathered state's, byte for byte), the JAX
checkpointer restores it, and a run restored from it and resumed equals the
uninterrupted run bit for bit; every leaf of the state's shardings gathers
back what ``local`` gave; ``remat="full"`` on the MoE equals ``"none"``
bit for bit; the γ-grid lane over ranks equals one process's (f32, rtol
1e-5), and a snapshotted ranked run resumes from its snapshot bit for
bit; the tap lane emits on rank 0 only and the breaker trips every rank
at the same round.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                           # noqa: E402
from torch_parity import rel_l2                                # noqa: E402

MESHES = {"data2": {"data": 2, "model": 1},
          "data4": {"data": 4, "model": 1},
          "pod2_data2": {"pod": 2, "data": 2, "model": 1}}
#: world size → the meshes one spawned world of that size runs, in turn
WORLDS = {2: ("data2",), 4: ("data4", "pod2_data2")}
SAME = ("dense_reference", "dense_pooled")
FAULT_SCENARIO = ("elastic:k=1,every=8,span=2;data_drift:a0=1.2,a1=2.0;"
                  "sparsify:frac=0.5;nan_grad:k=1,every=4,span=1")


def _params(name):
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    tr = D.port_trainer(name, None)
    return tree_map(lambda p: p.float(), M.init_params(tr.cfg, 0, "cpu"))


def _fault_spec():
    from repro_torch.api import ExperimentSpec, TrainJob

    return ExperimentSpec(objective=TrainJob(
        update_impl="pallas_pooled", guards=True, seq_len=16,
        arch_overrides=(("dtype", "float32"),)),
        n_workers=4, T=16, scenario=FAULT_SCENARIO)


def _f32_params(cfg, device):
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    return tree_map(lambda p: p.float(), M.init_params(cfg, 0, device))


def _fault_run(mesh=None):
    from repro_torch.api import TrainerBackend

    return TrainerBackend("cpu", mesh=mesh, params_fn=_f32_params).run(
        _fault_spec())


def _zero_and_bytes(mesh):
    """The pooled route's launches and shapes, and one round's tally."""
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import async_update as AU
    from repro_torch.launch import op_cost

    seen = []
    plain = AU.fused_adam_delayed_plain

    def counting(p, m, v, gbuf, g, scal, **kw):
        seen.append([tuple(t.shape) for t in (p, m, v, gbuf, g)])
        return plain(p, m, v, gbuf, g, scal, **kw)

    AU.fused_adam_delayed_plain = counting
    try:
        tr = D.port_trainer("dense_pooled", mesh)
        state = tr.init_state(params=_params("dense_pooled"))
        shapes = {k: tuple(t.shape) for k, t in
                  state["pools"]["bfloat16"].items()}
        step = tr.train_step_fn()
        batch = {"tokens": torch.from_numpy(
            D.tokens(tr.cfg.vocab, 8, 16, 0)).long()}
        mask = torch.from_numpy(D.mask(4, 0))
        for q in range(3):
            state, _ = step(state, batch, mask)
        before = C.snapshot()
        cost = op_cost.analyze(step, state, batch, mask)
        counted = C.since(before)
    finally:
        AU.fused_adam_delayed_plain = plain
    return {"launch_shapes": seen, "state_shapes": shapes,
            "cols": tr.pool_layout.cols["bfloat16"],
            "collective_bytes": cost.collective_bytes,
            "breakdown": cost.collective_breakdown, "counted": counted}


def _checkpoints(mesh, out_dir, rank):
    """Uninterrupted T 4 against 2 rounds, a ranked save, a restore and 2
    more; the final state saved ranked and, gathered, by rank 0 alone."""
    from repro_torch import checkpoint

    name = "dense_pooled"
    tr = D.port_trainer(name, mesh)
    sh = tr.state_shardings()
    step = tr.train_step_fn()

    def rounds(state, lo, hi):
        for q in range(lo, hi):
            batch = {"tokens": torch.from_numpy(
                D.tokens(tr.cfg.vocab, 8, 16, q)).long()}
            state, _ = step(state, batch, torch.from_numpy(D.mask(4, q)))
        return state

    whole = rounds(tr.init_state(params=_params(name)), 0, 4)
    half = rounds(tr.init_state(params=_params(name)), 0, 2)
    path = os.path.join(out_dir, "ckpt_half")
    checkpoint.save(path, half, step=2, shardings=sh)
    resumed = rounds(checkpoint.restore(
        path, tr.init_state(params=_params(name)), shardings=sh), 2, 4)
    checkpoint.save(os.path.join(out_dir, "ckpt_ranked"), whole, step=4,
                    shardings=sh)
    full = D.gathered(tr, whole)
    if rank == 0:
        checkpoint.save(os.path.join(out_dir, "ckpt_gathered"), full, step=4)
    return {"same": all(torch.equal(a, b) for a, b in zip(
        _leaves_t(D.gathered(tr, resumed)), _leaves_t(full))),
        "row_shapes": {k: tuple(t.shape) for k, t in
                       resumed["pools"]["bfloat16"].items()}}


def _leaves_t(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _sharding_roundtrip(mesh):
    """gather ∘ local on every leaf of reduced qwen2-0.5b's and
    deepseek-moe-16b's param (ZeRO), moment and batch specs."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.models import model as M
    from repro_torch.models.specs import meta_tree
    from repro_torch.tree import tree_leaves

    n = 0
    for arch in ("qwen2-0.5b", "deepseek-moe-16b"):
        cfg = get_arch(arch).reduced()
        for specs, zero in ((M.param_specs(cfg), True),
                            (M.param_specs(cfg), False),
                            (M.batch_specs(cfg, 8, 16), False)):
            for spec_sh, leaf in zip(
                    tree_leaves(tree_shardings(specs, mesh, zero=zero)),
                    tree_leaves(meta_tree(specs))):
                full = torch.arange(leaf.numel(), dtype=torch.float32
                                    ).reshape(leaf.shape)
                if not torch.equal(spec_sh.gather(
                        spec_sh.local(full).contiguous()), full):
                    return f"{arch}: {spec_sh}"
                n += 1
    return n


def _lane_spec(**kw):
    from repro_torch.api import ExperimentSpec, TrainJob

    return ExperimentSpec(objective=TrainJob(
        update_impl="pallas_pooled", seq_len=16,
        arch_overrides=(("dtype", "float32"),)), n_workers=4,
        rounds_per_launch=2, **kw)


def _grid_run(mesh=None):
    from repro_torch.api import TrainerBackend, grid

    res = TrainerBackend("cpu", mesh=mesh, params_fn=_f32_params).run(
        _lane_spec(T=4, stepsize=grid(1e-2, 5e-3)))
    return (res.extra["grid_lane"], res.gamma,
            {g: v["losses"] for g, v in res.grid.items()})


def _snapshot_resume(mesh, out_dir):
    """A snapshotted run (every 4 rounds of 8, K 2) against its resume from
    the round-4 snapshot, restored with the state's shardings."""
    from repro_torch.api import TrainerBackend
    from repro_torch.checkpoint import AsyncSnapshotter, restore
    from repro_torch.runtime import PlanExecutor, compile_plan

    spec = _lane_spec(T=8)
    snapdir = os.path.join(out_dir, "snaps")
    backend = TrainerBackend("cpu", mesh=mesh, params_fn=_f32_params,
                             snapshot=AsyncSnapshotter(snapdir, 4, keep=2))
    whole = backend.run(spec)
    tr, cfg, n = backend._make_trainer(spec, spec.objective,
                                       spec.stepsize.gamma, False,
                                       torch.device("cpu"))
    world = backend.world_for(spec, n)
    plan = compile_plan(world.schedule, spec.objective, rounds=spec.T,
                        n_groups=n, seed=spec.seed)
    like = tr.init_state(params=_f32_params(cfg, "cpu"))
    state = restore(os.path.join(snapdir, "round-00000004"), like,
                    shardings=tr.state_shardings())
    tail = PlanExecutor(tr, plan).run_scan(state, rounds_per_launch=2,
                                           start_round=4)
    same = all(torch.equal(a, b) for a, b in zip(
        _leaves_t(D.gathered(tr, tail.state)),
        _leaves_t(D.gathered(tr, whole.x))))
    return {"same": same, "files": sorted(os.listdir(snapdir)),
            "curve": bool(np.array_equal(tail.metrics["loss"],
                                         whole.losses[4:]))}


def _tap_breaker(mesh, rank, out_dir):
    """The tap lane with a divergence breaker on a corrupted-receipt world
    (T 16, K 4): each rank's trip round and the rows its ``on_step`` got,
    in a file of its own."""
    import json

    from repro_torch.api import ExperimentSpec, TrainerBackend, TrainJob
    from repro_torch.faults import DivergenceBreaker

    seen = []
    res = TrainerBackend(
        "cpu", mesh=mesh, metrics="tap", on_step=lambda i, s, m:
        seen.append(i), breaker=DivergenceBreaker(3, 5.0)).run(
        ExperimentSpec(objective=TrainJob(seq_len=16), n_workers=4, T=16,
                       rounds_per_launch=4,
                       scenario="corrupt_receipt:k=3,scale=1e4,every=4,"
                                "span=2"))
    with open(os.path.join(out_dir, f"tap{rank}.json"), "w") as f:
        json.dump({"tripped": res.extra["tripped_round"], "rows": seen,
                   "losses": res.losses.tolist()}, f)


def _remat_curves(mesh):
    """The MoE case (its aux shares all-reduce inside each layer) at remat
    "none" and "full": the recomputed blocks repeat their collectives."""
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    curves = {}
    for remat in ("none", "full"):
        tr = D.port_trainer("moe_pooled", mesh)
        tr.cfg = dataclasses.replace(tr.cfg, remat=remat)
        state = tr.init_state(params=tree_map(
            lambda p: p.float(), M.init_params(tr.cfg, 0, "cpu")))
        step = tr.train_step_fn()
        losses = []
        for q in range(3):
            batch = {"tokens": torch.from_numpy(
                D.tokens(tr.cfg.vocab, 8, 16, q)).long()}
            state, m = step(state, batch, torch.from_numpy(D.mask(4, q)))
            losses.append(m["loss"].item())
        curves[remat] = losses
    return curves


def _ranks(rank, world, out_dir, mesh_names):
    results = {name: _on_mesh(rank, out_dir, name) for name in mesh_names}
    if rank == 0:
        with open(os.path.join(out_dir, "port.pkl"), "wb") as f:
            pickle.dump(results, f)


def _on_mesh(rank, out_dir, mesh_name):
    from repro_torch.launch.mesh import ProcessMesh

    mesh = ProcessMesh(MESHES[mesh_name])
    out = {name: D.port_case(name, mesh, _params(name)) for name in SAME}
    out["sharding"] = _sharding_roundtrip(mesh)
    if mesh_name == "data2":
        res = _fault_run(mesh)
        out["faults"] = (res.losses, [m["skipped"] for m in
                                      res.extra["metrics"]], res.extra)
        out["zero"] = _zero_and_bytes(mesh)
        out["ckpt"] = _checkpoints(mesh, out_dir, rank)
        out["remat"] = _remat_curves(mesh)
        out["grid"] = _grid_run(mesh)
        out["snapshots"] = _snapshot_resume(mesh, out_dir)
        _tap_breaker(mesh, rank, out_dir)
        try:
            ProcessMesh({"data": 4, "model": 1})
            out["mismatch"] = None
        except ValueError as e:
            out["mismatch"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's ranks (the worlds side by side), and the one-process
    runs they are held to, made while the ranks run."""
    tmp = tmp_path_factory.mktemp("dp_ranks")
    started = [D.start(_ranks, world, tmp, names)
               for world, names in WORLDS.items()]
    one = {name: D.port_case(name, None, _params(name)) for name in SAME}
    one["faults"] = _fault_run()
    one["grid"] = _grid_run()
    ranked = {}
    for st in started:
        out = D.join(st)
        with open(os.path.join(out, "port.pkl"), "rb") as f:
            ranked.update({name: (res, out)
                           for name, res in pickle.load(f).items()})
    return ranked, one


def _trees(name, state):
    """{params, m, v, gbuf} trees of a numpy trainer state, pooled or
    not."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim.pool import build_layout, unpool_tree
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves_with_path

    st = params_from_numpy(state, "cpu")
    if "pools" not in st:
        return {"params": st["params"], "m": st["opt"]["m"],
                "v": st["opt"]["v"], "gbuf": st["gbuf"]}
    p = next(iter(st["pools"].values()))["p"]
    lay = build_layout(M.param_specs(D.port_trainer(name, None).cfg),
                       p.shape[0])
    return {k: unpool_tree(lay, {dk: b[k] for dk, b in st["pools"].items()})
            for k in ("p", "m", "v", "gbuf")}


@pytest.mark.parametrize("name", SAME)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ranks_equal_one_process(runs, mesh_name, name):
    from repro_torch.tree import tree_leaves_with_path

    ranked, one = runs
    got, want = ranked[mesh_name][0][name], one[name]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    g, w = _trees(name, got[2]), _trees(name, want[2])
    for kind in w:
        gl, wl = dict(tree_leaves_with_path(g[kind])), \
            dict(tree_leaves_with_path(w[kind]))
        assert sorted(gl) == sorted(wl)
        for path, b in wl.items():
            bound = 1e-2 if path.endswith("['bk']") else 1e-4
            assert rel_l2(gl[path].float().numpy(),
                          b.float().numpy()) <= bound, (kind, path)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharding_gather_of_local_is_identity(runs, mesh_name):
    n = runs[0][mesh_name][0]["sharding"]
    assert isinstance(n, int) and n > 40, n


def test_guarded_fault_world_skips_the_same_rounds(runs):
    losses, skipped, extra = runs[0]["data2"][0]["faults"]
    one = runs[1]["faults"]
    assert skipped == [m["skipped"] for m in one.extra["metrics"]]
    assert sum(skipped) >= 1
    fin = np.isfinite(one.losses)
    np.testing.assert_array_equal(np.isfinite(losses), fin)
    np.testing.assert_allclose(losses[fin], one.losses[fin], rtol=5e-3)
    assert extra["mesh"] == {"data": 2, "model": 1} and extra["ranks"] == 2
    assert one.extra["ranks"] == 1 and one.extra["mesh"] is None
    assert extra["collectives"]["reduce_scatter"][0] == 0   # sparsified
    assert extra["collectives"]["all_gather"][0] > 0


def test_zero_rows_and_one_launch_per_pool(runs):
    z = runs[0]["data2"][0]["zero"]
    cols = z["cols"]
    # three rounds and the traced one: one launch each (one dtype pool)
    assert len(z["launch_shapes"]) == 4
    assert all(s == [(1, cols)] * 5 for s in z["launch_shapes"])
    assert z["state_shapes"] == {"p": (2, cols), "m": (1, cols),
                                 "v": (1, cols), "gbuf": (1, cols)}


def test_round_collective_bytes_equal_the_hand_count(runs):
    """Per round on 2 ranks (f32 grads and params, one pool): the pool's
    reduce-scatter (2 × cols × 4 B) and its p all-gather (cols × 4 B), the
    norm's per-pool norms (4 B), the loss's global Σ mask (4 B) and its
    three shares (12 B)."""
    z = runs[0]["data2"][0]["zero"]
    cols = z["cols"]
    assert z["breakdown"] == {"reduce-scatter": 2 * cols * 4,
                              "all-gather": cols * 4 + 4,
                              "all-reduce": 4 + 12}
    assert z["collective_bytes"] == 3 * cols * 4 + 20
    assert z["counted"] == {"all_reduce": [2, 16],
                            "all_gather": [2, cols * 4 + 4],
                            "reduce_scatter": [1, 2 * cols * 4]}


def test_ranked_checkpoint_is_the_jax_file_and_resumes_bitwise(runs):
    import jax.numpy as jnp

    from repro import checkpoint as jckpt

    out, out_dir = runs[0]["data2"]
    assert out["ckpt"]["same"]
    cols = out["zero"]["cols"]
    assert out["ckpt"]["row_shapes"] == {"p": (2, cols), "m": (1, cols),
                                         "v": (1, cols), "gbuf": (1, cols)}
    ranked = np.load(os.path.join(out_dir, "ckpt_ranked", "state.npz"))
    gathered = np.load(os.path.join(out_dir, "ckpt_gathered", "state.npz"))
    assert sorted(ranked.files) == sorted(gathered.files)
    for k in ranked.files:
        assert ranked[k].dtype == gathered[k].dtype
        assert ranked[k].tobytes() == gathered[k].tobytes(), k
    like = {"pools": {"bfloat16": {k: jnp.zeros((2, cols), jnp.float32)
                                   for k in ("p", "m", "v", "gbuf")}},
            "opt": {"count": jnp.zeros((), jnp.int32)},
            "step": jnp.zeros((), jnp.int32)}
    back = jckpt.restore(os.path.join(out_dir, "ckpt_ranked"), like)
    for k in ("p", "m", "v", "gbuf"):
        np.testing.assert_array_equal(
            np.asarray(back["pools"]["bfloat16"][k]),
            ranked[f"['pools']['bfloat16']['{k}']"])
    assert int(back["step"]) == 4


def test_remat_under_ranks_equals_no_remat(runs):
    """``remat="full"`` under ranks recomputes each MoE block with its
    collectives; on the CPU the curve equals ``remat="none"``'s bit for
    bit, as without ranks (``tests/test_torch_tap_grid.py``)."""
    curves = runs[0]["data2"][0]["remat"]
    assert curves["full"] == curves["none"]


def test_grid_lane_under_ranks_equals_one_process(runs):
    lane, gamma, curves = runs[0]["data2"][0]["grid"]
    one_lane, one_gamma, one_curves = runs[1]["grid"]
    assert lane and one_lane and gamma == one_gamma
    for g, c in one_curves.items():
        np.testing.assert_allclose(curves[g], c, rtol=1e-5)


def test_snapshots_under_ranks_resume_bitwise(runs):
    """The executor hands the snapshotter the state's shardings: the ranks
    gather, rank 0 writes the rounds 4 and 8, and a run restored from
    round 4 and resumed ends where the snapshotted run ended, bit for
    bit."""
    snaps = runs[0]["data2"][0]["snapshots"]
    assert snaps["files"] == ["round-00000004", "round-00000008"]
    assert snaps["same"] and snaps["curve"]


def test_tap_emits_on_rank_zero_and_the_breaker_trips_together(runs):
    """Under ranks the tap hands rows to ``on_step`` on rank 0 only, every
    rank's curve is the same, and the breaker stops every rank at the same
    round."""
    import json

    out_dir = runs[0]["data2"][1]
    taps = [json.load(open(os.path.join(out_dir, f"tap{r}.json")))
            for r in (0, 1)]
    assert taps[0]["tripped"] is not None
    assert taps[0]["tripped"] == taps[1]["tripped"]
    assert taps[0]["losses"] == taps[1]["losses"]
    assert taps[0]["rows"] == list(range(len(taps[0]["losses"])))
    assert taps[1]["rows"] == []


def test_a_mesh_off_the_world_size_is_an_error(runs):
    assert "has 4 devices but the process group has 2 ranks" in \
        runs[0]["data2"][0]["mismatch"]
