"""Per-leaf ZeRO over the data axes: gloo ranks against one process on the
per-leaf routes, and what a round sends.

On a mesh with data > 1 the per-leaf routes (``reference``, and ``pallas``:
the update kernels on each rank's blocks, their plain versions on the CPU)
hold each rank's ZeRO blocks of params, m, v and gbuf; each layer is
gathered over the data group when the model reads it, and the backward
reduce-scatters each gradient into its block.  Ranks are spawned over gloo
(``tests/torch_dp.py``): a world of two runs ``(data 2, model 1)``, a world
of four ``(data 2, model 2)``.  Reduced qwen2-0.5b and deepseek-moe-16b in
f32 (the port's params cast to f32), delay 1, T 4.

Against one process: the curves within rtol 1e-5; the final params, m, v
and gbuf within 1e-4 relative L2 per leaf, the attention key bias within
1e-2 and the MoE within 1e-3 (the bounds of ``tests/test_torch_dp_ranks.py``
and ``tests/test_torch_tp_ranks.py``: the q and k biases' gradients nearly
cancel, and Adam turns a summation order's rounding into lr-sized steps).
The MoE at two data ranks dispatches in JAX's two groups, so at (2, 1) it
is held to the pooled route's run on the same mesh, and at (2, 2) to the
same route's run at (2, 1).  Also against one process: a clip norm of
1e-3, which the gradient's norm exceeds, on qwen2 with QK-norm, whose
``q_norm`` / ``k_norm`` no rule splits, so that leaves of all four norm
classes count (split over data; data and model; model; neither) and the
reported norms agree within rtol 1e-5.  ``global_norm`` over a rank's
blocks of four leaves, one of each class, equals the whole tree's norm
(rtol 1e-6) with two all-reduces.  The (2, 1) lanes (microbatches, the
guarded fault world, the collectives, the grid lane) are in
``tests/test_torch_zero_lanes.py``.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                           # noqa: E402
from torch_parity import rel_l2                                # noqa: E402

WORLDS = {2: {"data": 2, "model": 1}, 4: {"data": 2, "model": 2}}
TRAIN = ("dense_reference", "dense_pallas", "moe_reference", "moe_pallas")
CLIP = 1e-3


def _key(mesh):
    return "x".join(f"{k}{v}" for k, v in mesh.items())


def _params(name, cfg=None):
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = cfg or D.port_trainer(name, None).cfg
    return tree_map(lambda p: p.float(), M.init_params(cfg, 0, "cpu"))


def _clip_case(mesh):
    """qwen2 with QK-norm on the fused route at clip norm ``CLIP``: (losses,
    grad norms, final state as numpy)."""
    from repro_torch.distributed import AsyncConfig, AsyncTrainer
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.optim import OptConfig

    cfg = D.port_trainer("dense_pallas", None).cfg.with_(qk_norm=True)
    tr = AsyncTrainer(cfg, OptConfig(lr=D.LR, clip_norm=CLIP,
                                     update_impl="pallas"),
                      AsyncConfig(delay_rounds=1), device="cpu", mesh=mesh)
    tr.n_groups = 4
    state = tr.init_state(params=_params(None, cfg))
    step = tr.train_step_fn()
    losses, norms = [], []
    for q in range(4):
        b = {k: torch.from_numpy(v) for k, v in
             D.batch(cfg, M.batch_specs(cfg, 8, 16), q).items()}
        state, m = step(state, {"tokens": b["tokens"].long()},
                        torch.from_numpy(D.mask(4, q)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return (np.asarray(losses), np.asarray(norms),
            params_to_numpy(D.gathered(tr, state)))


def _norm_classes(mesh):
    """``global_norm`` over this rank's blocks of one leaf of each class,
    against the whole tree's, and the all-reduces it ran."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (NamedSharding, PSpec,
                                                  split_axes)
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_map

    gen = torch.Generator().manual_seed(3)
    whole = {"both": torch.randn(4, 6, generator=gen),
             "data": torch.randn(6, generator=gen),
             "model": torch.randn(4, generator=gen),
             "neither": torch.randn(3, generator=gen)}
    sh = {"both": NamedSharding(mesh, PSpec("data", "model")),
          "data": NamedSharding(mesh, PSpec("data")),
          "model": NamedSharding(mesh, PSpec("model")),
          "neither": NamedSharding(mesh, PSpec(None))}
    classes = tree_map(lambda s: split_axes(s.spec, mesh), sh)
    blocks = tree_map(lambda t, s: s.local(t), whole, sh)
    before = C.snapshot()
    got = global_norm(blocks, split=classes, groups={
        "data": mesh.group(("data",)), "model": mesh.group(("model",))})
    return {"classes": classes, "got": float(got),
            "want": float(global_norm(whole)),
            "all_reduce": C.since(before)["all_reduce"]}


def _ranks(rank, world, out_dir):
    from repro_torch.launch.mesh import ProcessMesh

    shape = WORLDS[world]
    mesh = ProcessMesh(shape)
    out = {name: D.port_case(name, mesh, _params(name)) for name in TRAIN}
    out["clip"] = _clip_case(mesh)
    if world == 2:
        # the MoE's baseline on this mesh
        out["moe_pooled"] = D.port_case("moe_pooled", mesh,
                                        _params("moe_pooled"))
    else:
        out["norm"] = _norm_classes(mesh)
    if rank == 0:
        with open(os.path.join(out_dir, "port.pkl"), "wb") as f:
            pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds side by side, and one process's runs meanwhile."""
    tmp = tmp_path_factory.mktemp("zero_ranks")
    started = {w: D.start(_ranks, w, tmp / f"w{w}") for w in WORLDS}
    one = {name: D.port_case(name, None, _params(name))
           for name in ("dense_reference", "dense_pallas")}
    one["clip"] = _clip_case(None)
    port = {}
    for w, st in started.items():
        with open(os.path.join(D.join(st), "port.pkl"), "rb") as f:
            port[_key(WORLDS[w])] = pickle.load(f)
    return one, port


def _leaves(tree):
    from repro_torch.tree import tree_leaves_with_path
    return dict(tree_leaves_with_path(tree))


def _check_state(got, want, moe=False):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if w.ndim == 0:
            assert got[path] == w, path
            continue
        bound = 1e-2 if path.endswith("['bk']") else 1e-3 if moe else 1e-4
        assert rel_l2(np.asarray(got[path], np.float32),
                      np.asarray(w, np.float32)) <= bound, path


def _want(one, port, mesh, name):
    """What ``name`` on ``mesh`` is held to (module docstring)."""
    if name.startswith("moe"):
        if mesh["model"] > 1:
            return port["data2xmodel1"][name]
        return port["data2xmodel1"]["moe_pooled"]
    return one[name]


CASES = [(w, n) for w in WORLDS for n in TRAIN]


@pytest.mark.parametrize("world,name", CASES,
                         ids=[f"{_key(WORLDS[w])}-{n}" for w, n in CASES])
def test_per_leaf_zero_ranks_equal_one_process(runs, world, name):
    one, port = runs
    mesh = WORLDS[world]
    got, want = port[_key(mesh)][name], _want(one, port, mesh, name)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    _check_state(_trees(got[2]), _trees(want[2]), moe=name.startswith("moe"))


def _trees(state):
    """{params, m, v, gbuf} of a numpy trainer state (a pooled one's pools,
    at two data ranks, unpooled), as numpy."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy, \
        params_to_numpy
    from repro_torch.optim.pool import build_layout, unpool_tree

    if "pools" not in state:
        return {"params": state["params"], "m": state["opt"]["m"],
                "v": state["opt"]["v"], "gbuf": state["gbuf"]}
    pools = params_from_numpy(state["pools"], "cpu")
    lay = build_layout(M.param_specs(get_arch("deepseek-moe-16b").reduced()),
                       2)
    return {k: params_to_numpy(unpool_tree(lay, {
        dk: b[kp] for dk, b in pools.items()}))
        for k, kp in (("params", "p"), ("m", "m"), ("v", "v"),
                      ("gbuf", "gbuf"))}


@pytest.mark.parametrize("world", list(WORLDS))
def test_engaged_clip_counts_every_norm_class(runs, world):
    one, port = runs
    losses, norms, state = port[_key(WORLDS[world])]["clip"]
    assert (norms[1:] > CLIP).all()            # the clip engages
    np.testing.assert_allclose(losses, one["clip"][0], rtol=1e-5)
    np.testing.assert_allclose(norms, one["clip"][1], rtol=1e-5)
    _check_state(state, one["clip"][2])


def test_norm_sums_each_class_over_its_groups(runs):
    res = runs[1]["data2xmodel2"]["norm"]
    assert res["classes"] == {"both": "data+model", "data": "data",
                              "model": "model", "neither": ""}
    np.testing.assert_allclose(res["got"], res["want"], rtol=1e-6)
    assert res["all_reduce"] == [2, 2 * 8]
