"""Per-leaf ZeRO at (data 2, model 1) on gloo ranks: the trainer's other
lanes, and what a round sends.  ``tests/test_torch_zero_ranks.py`` holds
the per-leaf routes to one process; its helpers and bounds serve here.

Against one process on reduced qwen2-0.5b in f32: two microbatches (block
gradients accumulated in f32), curves within rtol 1e-5 and the final
params, m, v and gbuf within 1e-4 relative L2 per leaf (the key bias
1e-2); a guarded ``FAULT_SCENARIO`` backend run with its sparsifier on the
fused per-leaf route, which skips the same rounds (curve within the faults
test's rtol 5e-3).  A round's collectives equal the hand count at remat
``"none"`` and ``"full"`` (the layers gathered twice), and the two give
the same curve bit for bit.  The grid lane's stacked per-leaf state,
snapshotted under ranks, resumes bit for bit.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                           # noqa: E402
from test_torch_zero_ranks import (_check_state, _params,  # noqa: E402
                                   _trees)

MESH = {"data": 2, "model": 1}
FAULT_SCENARIO = ("elastic:k=1,every=8,span=2;data_drift:a0=1.2,a1=2.0;"
                  "sparsify:frac=0.5;nan_grad:k=1,every=4,span=1")


def _f32_params(cfg, device):
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    return tree_map(lambda p: p.float(), M.init_params(cfg, 0, device))


def _fault_run(mesh=None):
    from repro_torch.api import ExperimentSpec, TrainerBackend, TrainJob

    res = TrainerBackend("cpu", mesh=mesh, params_fn=_f32_params).run(
        ExperimentSpec(objective=TrainJob(
            update_impl="pallas", guards=True, seq_len=16,
            arch_overrides=(("dtype", "float32"),)),
            n_workers=4, T=16, scenario=FAULT_SCENARIO))
    return res.losses, [m["skipped"] for m in res.extra["metrics"]]


def _collectives(mesh, remat):
    """One (2, 1) round of the reference case at ``remat``: the counters'
    and the tally's collectives, and the curve of three rounds."""
    import dataclasses

    from repro_torch.distributed import collectives as C
    from repro_torch.launch import op_cost

    tr = D.port_trainer("dense_reference", mesh)
    tr.cfg = dataclasses.replace(tr.cfg, remat=remat)
    state = tr.init_state(params=_params("dense_reference"))
    step = tr.train_step_fn()
    losses = []
    for q in range(3):
        batch = {"tokens": torch.from_numpy(D.tokens(tr.cfg.vocab, 8, 16,
                                                     q)).long()}
        mask = torch.from_numpy(D.mask(4, q))
        state, m = step(state, batch, mask)
        losses.append(m["loss"].item())
    before = C.snapshot()
    cost = op_cost.analyze(step, state, batch, mask)
    return {"counted": C.since(before), "bytes": cost.collective_bytes,
            "losses": losses}


def _grid_snapshots(mesh, out_dir):
    """The grid lane on the fused per-leaf route (T 8, K 2, two γ),
    snapshotted every 4 rounds, against its resume from round 4."""
    from repro_torch.api import ExperimentSpec, TrainerBackend, TrainJob, \
        grid
    from repro_torch.checkpoint import AsyncSnapshotter, restore
    from repro_torch.runtime import PlanExecutor, compile_plan
    from repro_torch.tree import tree_leaves, tree_map

    spec = ExperimentSpec(objective=TrainJob(
        update_impl="pallas", seq_len=16,
        arch_overrides=(("dtype", "float32"),)), n_workers=4,
        rounds_per_launch=2, T=8, stepsize=grid(1e-2, 5e-3))
    snapdir = os.path.join(out_dir, "grid_snaps")
    backend = TrainerBackend("cpu", mesh=mesh, params_fn=_f32_params,
                             snapshot=AsyncSnapshotter(snapdir, 4, keep=2))
    whole = backend.run(spec)
    tr, cfg, n = backend._make_trainer(spec, spec.objective,
                                       spec.stepsize.gammas[0], False,
                                       torch.device("cpu"))
    world = backend.world_for(spec, n)
    plan = compile_plan(world.schedule, spec.objective, rounds=spec.T,
                        n_groups=n, seed=spec.seed,
                        grid_gammas=spec.stepsize.gammas)
    ex = PlanExecutor(tr, plan)
    like = ex.stack_state(tr.init_state(params=_f32_params(cfg, "cpu")))
    state = restore(os.path.join(snapdir, "round-00000004"), like,
                    shardings=tree_map(lambda s: s.stacked(),
                                       tr.state_shardings()))
    tail = ex.run_grid(state, rounds_per_launch=2, start_round=4)
    best = list(spec.stepsize.gammas).index(whole.gamma)
    return {"lane": whole.extra["grid_lane"],
            "blocks": tuple(state["params"]["embed"].shape),
            "whole": (cfg.vocab, cfg.d_model),
            "same": all(torch.equal(a[best], b) for a, b in zip(
                tree_leaves(tail.state), tree_leaves(whole.x))),
            "curves": all(np.array_equal(
                tail.metrics["loss"][i].astype(np.float64),
                whole.grid[g]["losses"][4:])
                for i, g in enumerate(spec.stepsize.gammas))}


def _ranks(rank, world, out_dir):
    from repro_torch.launch.mesh import ProcessMesh

    mesh = ProcessMesh(MESH)
    out = {"mb2": D.port_case("dense_reference_mb2", mesh,
                              _params("dense_reference_mb2")),
           "faults": _fault_run(mesh),
           "collectives": {r: _collectives(mesh, r)
                           for r in ("none", "full")},
           "grid": _grid_snapshots(mesh, out_dir)}
    if rank == 0:
        with open(os.path.join(out_dir, "port.pkl"), "wb") as f:
            pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks, and one process's runs meanwhile."""
    started = D.start(_ranks, 2, tmp_path_factory.mktemp("zero_lanes"))
    one = {"mb2": D.port_case("dense_reference_mb2", None,
                              _params("dense_reference_mb2")),
           "faults": _fault_run()}
    with open(os.path.join(D.join(started), "port.pkl"), "rb") as f:
        port = pickle.load(f)
    return one, port


def test_two_microbatches_equal_one_process(runs):
    one, port = runs
    np.testing.assert_allclose(port["mb2"][0], one["mb2"][0], rtol=1e-5)
    _check_state(_trees(port["mb2"][2]), _trees(one["mb2"][2]))


def test_guarded_fault_world_skips_the_same_rounds(runs):
    one, port = runs
    losses, skipped = port["faults"]
    assert skipped == one["faults"][1] and sum(skipped) >= 1
    fin = np.isfinite(one["faults"][0])
    np.testing.assert_array_equal(np.isfinite(losses), fin)
    np.testing.assert_allclose(losses[fin], one["faults"][0][fin],
                               rtol=5e-3)


def _hand_count(remat):
    """One round at (data 2, model 1), reduced qwen2-0.5b in f32 on the
    per-leaf reference route: {kind: [calls, bytes]}."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M

    specs = M.param_specs(get_arch("qwen2-0.5b").reduced())
    f = 4
    top = [s for k, s in specs.items() if k != "blocks"]
    layer = [s for sub in specs["blocks"].values() for s in sub.values()]
    L = layer[0].shape[0]
    nbytes = lambda s: int(np.prod(s.shape)) * f
    # every leaf splits in two over the data ranks: the top-level leaves
    # gathered once a forward, each layer's in its block (again in the
    # backward under remat), each use's gradient reduce-scattered whole
    again = 2 if remat == "full" else 1
    gathers = [len(top) + again * len(layer) * L,
               sum(nbytes(s) // 2 for s in top)
               + again * sum(nbytes(s) // 2 for s in layer)]
    scatters = [len(top) + len(layer) * L,
                sum(nbytes(s) for s in top + layer)]
    # the loss's global Σ mask and its three shares; the clip norm's
    # data-split squares
    return {"all_reduce": [3, f + 3 * f + f], "all_gather": gathers,
            "reduce_scatter": scatters}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_a_rounds_collectives_equal_the_hand_count(runs, remat):
    got = runs[1]["collectives"][remat]
    want = _hand_count(remat)
    assert got["counted"] == want
    assert got["bytes"] == sum(b for _, b in want.values())


def test_remat_full_equals_none_under_zero(runs):
    """The gathers of a recomputed block repeat in the backward: the curve
    is the one without remat, bit for bit."""
    c = runs[1]["collectives"]
    assert c["full"]["losses"] == c["none"]["losses"]


def test_grid_lane_stacked_zero_state_resumes_bitwise(runs):
    g = runs[1]["grid"]
    assert g["lane"] and g["same"] and g["curves"]
    # two γ points stacked, each embedding split on its width
    V, d = g["whole"]
    assert g["blocks"] == (2, V, d // 2)
