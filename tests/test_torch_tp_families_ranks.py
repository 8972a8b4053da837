"""Tensor parallelism of the ssm, hybrid, audio and vlm families over gloo
ranks against one process.

Ranks are spawned over gloo (``tests/torch_dp.py``): a world of two runs
the mesh ``(data 1, model 2)``, a world of four ``(data 2, model 2)``
and ``(data 1, model 4)``.  The trainer cases are ``torch_dp``'s
``FAMILY_CASES``: reduced mamba2-370m, zamba2-7b with a tail (three
layers, the shared block every two), seamless-m4t-large-v2 and
pixtral-12b, the port's params cast to f32, T 4, on the per-leaf
reference route and the pooled route.  Against one process: the curves
within rtol 1e-5; the round's gradient (the delayed buffer after round 0)
within 1e-5 relative L2 per leaf on both routes, every leaf included
(``conv_w``, ``conv_b``, ``in_B``, ``in_C``, ``gate_norm``, the hybrid's
shared block and tail, the audio encoder and cross-attention, the vlm
projector).
The splits the reduced configs reach: mamba2-370m's 16 SSM heads and
576 conv columns split at model 2 and 4 (the conv block never lines up
with the heads: 288 against 256 x columns at model 2); zamba2-7b's two
attention heads split at model 2 and gathered at model 4; seamless's 4
heads split at both, its 512 words vocab-parallel; pixtral's 2 heads
split at model 2, gathered at model 4, its projector gathered.

Serving: the lock-step ``Server`` on each mesh gives one process's greedy
tokens from the same prefilled prompts for mamba2-370m and zamba2-7b (a
prompt of the SSD chunk's length), and, at the model level (``prefill``
with frames or patches under the mesh's context, then
``Server.generate`` from that cache), for seamless-m4t-large-v2 and
pixtral-12b; ``ServeBackend(mesh=)`` at model 2 gives one process's token
matrix for mamba2-370m.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                           # noqa: E402
from torch_parity import rel_l2                                # noqa: E402

#: world size → the meshes its ranks run, in turn
WORLDS = {2: ({"data": 1, "model": 2},),
          4: ({"data": 2, "model": 2}, {"data": 1, "model": 4})}
TRAIN = tuple(D.FAMILY_CASES)
MESH_CASES = [(m, n) for w in WORLDS for m in WORLDS[w] for n in TRAIN]
#: the served case of each family (its reference trainer case's config)
SERVED = tuple(n for n in TRAIN if n.endswith("reference"))
SERVE_CASES = [(m, n) for w in WORLDS for m in WORLDS[w] for n in SERVED]
SERVE_B, SERVE_S, SERVE_T, SERVE_CTX = 4, 16, 6, 24


def _key(mesh):
    return "x".join(f"{k}{v}" for k, v in mesh.items())


def _params(name):
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    tr = D.port_trainer(name, None)
    return tree_map(lambda p: p.float(), M.init_params(tr.cfg, 0, "cpu"))


def _serve(name, mesh=None):
    """Greedy tokens: the prompts (and their frames or patches) prefilled,
    the rank's rows under the mesh's context, then ``SERVE_T`` decode
    steps of the ``Server``."""
    from repro_torch.distributed import Server, ServeConfig
    from repro_torch.distributed.sharding import sharded_trace
    from repro_torch.models import model as M

    cfg = D.port_trainer(name, None).cfg
    server = Server(cfg, ServeConfig(batch=SERVE_B, ctx_len=SERVE_CTX),
                    device="cpu", mesh=mesh)
    params = _params(name)
    batch = {k: torch.from_numpy(v) for k, v in D.batch(
        cfg, M.batch_specs(cfg, SERVE_B, SERVE_S), 7).items()}
    batch["tokens"] = batch["tokens"].long()
    start = batch["tokens"].shape[1]
    pre = M.prefill
    if mesh is not None:
        from repro_torch.tree import tree_map

        params = tree_map(lambda t, sh: sh.local(t), params,
                          server.param_shardings())
        batch = {k: server.batch_sharding().local(v)
                 for k, v in batch.items()}
        pre = sharded_trace(M.prefill, mesh)
    with torch.no_grad():
        last, cache = pre(cfg, params, batch, ctx_len=SERVE_CTX)
        first = last.argmax(-1)
        if mesh is not None:
            first = server.batch_sharding().gather(first)
        toks = server.generate(params, first.numpy(), SERVE_T,
                               start_pos=start, cache=cache)
    return np.concatenate([first.numpy()[:, None], toks], 1)


def _serve_backend(mesh=None):
    """``ServeBackend``'s lock-step lane on reduced mamba2-370m (f32
    activations): its token matrix."""
    from repro_torch.api import ExperimentSpec, ServeBackend, ServeJob

    return ServeBackend("cpu", mesh=mesh).run(ExperimentSpec(
        objective=ServeJob(arch="mamba2-370m", batch=2, prompt_len=16,
                           arch_overrides=(("dtype", "float32"),)), T=5)).x


def _ranks(rank, world, out_dir):
    from repro_torch.launch.mesh import ProcessMesh

    out = {}
    for shape in WORLDS[world]:
        mesh = ProcessMesh(shape)
        for name in TRAIN:
            out[_key(shape), name] = D.port_case(name, mesh, _params(name))
        for name in SERVED:
            out[_key(shape), "serve", name] = _serve(name, mesh)
        if shape == {"data": 1, "model": 2}:
            out["serve_backend"] = _serve_backend(mesh)
    if rank == 0:
        with open(os.path.join(out_dir, "port.pkl"), "wb") as f:
            pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds side by side, and one process's runs meanwhile."""
    tmp = tmp_path_factory.mktemp("tp_families")
    started = [D.start(_ranks, w, tmp) for w in WORLDS]
    one = {name: D.port_case(name, None, _params(name)) for name in TRAIN}
    for name in SERVED:
        one["serve", name] = _serve(name)
    one["serve_backend"] = _serve_backend()
    port = {}
    for s in started:
        with open(os.path.join(D.join(s), "port.pkl"), "rb") as f:
            port.update(pickle.load(f))
    return one, port


def _f32(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _leaves(tree):
    from repro_torch.tree import tree_leaves_with_path
    return dict(tree_leaves_with_path(tree))


def _ids(cases):
    return [f"{_key(m)}-{n}" for m, n in cases]


@pytest.mark.parametrize("mesh,name", MESH_CASES, ids=_ids(MESH_CASES))
def test_curves_equal_one_process(runs, mesh, name):
    one, port = runs
    np.testing.assert_allclose(port[_key(mesh), name][0], one[name][0],
                               rtol=1e-5)


@pytest.mark.parametrize("mesh,name", MESH_CASES, ids=_ids(MESH_CASES))
def test_round_grads_equal_one_process_per_leaf(runs, mesh, name):
    one, port = runs
    got = _leaves(port[_key(mesh), name][1])
    want = _leaves(one[name][1])
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert rel_l2(_f32(got[path]), _f32(w)) <= 1e-5, path


@pytest.mark.parametrize("mesh,name", SERVE_CASES, ids=_ids(SERVE_CASES))
def test_server_greedy_tokens_equal_one_process(runs, mesh, name):
    one, port = runs
    np.testing.assert_array_equal(port[_key(mesh), "serve", name],
                                  one["serve", name])


def test_serve_backend_on_model_2_gives_one_process_tokens(runs):
    one, port = runs
    np.testing.assert_array_equal(port["serve_backend"], one["serve_backend"])
