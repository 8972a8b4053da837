"""The port's tensor-parallel trainer and server against the JAX package's on
the same meshes.

Two JAX subprocesses (``tests/torch_tp.py``, four forced host devices,
the dense cases and the server in one, the MoE's in the other) run the
JAX trainer's own compiled step on the meshes ``(data 2, model 2)`` and
``(data 1, model 4)`` for ``torch_dp.CASES``' f32 cases of reduced
qwen2-0.5b and deepseek-moe-16b on the reference and pooled routes, and
the JAX ``Server`` on ``(data 1, model 2)`` (reduced qwen2-0.5b in f32,
prefilled prompts, greedy).  The port's ranks, spawned over gloo beside
them, run the same cases from the params the JAX subprocesses draw first:
a world of four on both trainer meshes, a world of two serving on
``(data 1, model 2)``.  Tolerances, those of
``tests/test_torch_dp_jax.py``: f32 curves within 1e-4 relative; one
round's gradient (the delayed buffer after round 0) within 1.7e-4
relative L2 per leaf.  The server's greedy tokens are equal.

The weights cross as numpy (``models.convert``): the JAX params become
each rank's blocks through ``params_blocks``, and the JAX trainer's
initial state (checked equal to the one the JAX subprocess holds, bit for
bit) becomes each rank's blocks or rows through ``state_from_numpy`` with
the trainer's shardings, on both routes; ``NamedSharding.gather`` over
the ranks gives back the whole tree bit for bit.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                           # noqa: E402
import torch_tp as TT                                          # noqa: E402
from torch_parity import rel_l2                                # noqa: E402

NAMES = ("dense_reference", "dense_pooled", "moe_reference", "moe_pooled")
MESHES = ((2, 2), (1, 4))
ENTRIES = [f"{n}@{d}x{m}" for d, m in MESHES for n in NAMES]
JAX_GROUPS = ([e for e in ENTRIES if e.startswith("dense")] + ["serve@1x2"],
              [e for e in ENTRIES if e.startswith("moe")])


def _trainer_ranks(rank, world, out_dir, params_paths):
    out = TT.trainer_ranks(MESHES, NAMES, params_paths)
    if rank == 0:
        with open(os.path.join(out_dir, "port.pkl"), "wb") as f:
            pickle.dump(out, f)


def _serve_ranks(rank, world, out_dir, params_paths):
    from repro_torch.launch.mesh import ProcessMesh

    res = TT.port_serve("serve", ProcessMesh({"data": 1, "model": 2}),
                        params_paths)
    if rank == 0:
        with open(os.path.join(out_dir, "serve.pkl"), "wb") as f:
            pickle.dump(res, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_jax")
    paths = [(str(tmp / f"jax{i}.npz"), str(tmp / f"params{i}.npz"))
             for i in range(len(JAX_GROUPS))]
    procs = [TT.start_jax(out, params, entries)
             for (out, params), entries in zip(paths, JAX_GROUPS)]
    alive = lambda: all(p.poll() in (None, 0) for p in procs)
    params = [p for _, p in paths]
    try:
        started = [D.start(_trainer_ranks, 4, tmp / "w4", params),
                   D.start(_serve_ranks, 2, tmp / "w2", params)]
        outs = [D.join(s, alive=alive) for s in started]
    finally:
        D.wait_jax(procs)
    with open(os.path.join(outs[0], "port.pkl"), "rb") as f:
        port = pickle.load(f)
    with open(os.path.join(outs[1], "serve.pkl"), "rb") as f:
        port["serve"] = pickle.load(f)
    jres = {}
    for jax_path, _ in paths:
        jres.update(TT.results(jax_path))
    return jres, port


def _f32(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


@pytest.mark.parametrize("entry", ENTRIES)
def test_curves_match_jax_on_the_mesh(runs, entry):
    jres, port = runs
    np.testing.assert_allclose(port[entry]["case"][0],
                               jres[entry]["losses"], rtol=1e-4)


@pytest.mark.parametrize("entry", ENTRIES)
def test_one_round_grads_match_jax_per_leaf(runs, entry):
    from repro_torch.tree import tree_leaves_with_path

    jres, port = runs
    got = dict(tree_leaves_with_path(port[entry]["case"][1]))
    assert sorted(got) == sorted(jres[entry]["grads"])
    for path, want in jres[entry]["grads"].items():
        assert rel_l2(_f32(got[path]), _f32(want)) <= 1.7e-4, path


@pytest.mark.parametrize("entry", ENTRIES)
def test_jax_state_crosses_to_the_ranks_and_back_bitwise(runs, entry):
    jres, port = runs
    from repro_torch.tree import tree_leaves_with_path

    mine = dict(tree_leaves_with_path(port[entry]["jax_state"]))
    for path, want in jres[entry]["first"].items():
        np.testing.assert_array_equal(np.asarray(mine[path]), want,
                                      err_msg=path)
    assert port[entry]["round_trip"]


def test_server_tokens_match_jax_on_model_2(runs):
    jres, port = runs
    np.testing.assert_array_equal(port["serve"]["tokens"],
                                  jres["serve@1x2"]["tokens"])


def test_jax_params_cross_as_blocks_and_gather_back_bitwise(runs):
    from repro_torch.configs import get_arch

    _, port = runs
    assert port["serve"]["round_trip"]
    cfg = D.case_cfg(TT.SERVES["serve"][0], get_arch)
    assert port["serve"]["block_shape"] == (cfg.vocab // 2, cfg.d_model)
