"""Tensor parallelism over gloo ranks against one process, and what the ranks
send and save.

Ranks are spawned over gloo (``tests/torch_dp.py``): one world of two runs
the meshes ``(data 1, model 2)`` and ``(data 2, model 1)`` in turn, one
world of four runs ``(data 2, model 2)`` and ``(data 1, model 4)``.  The
trainer cases are ``torch_dp.CASES``' f32 ones (reduced qwen2-0.5b and
deepseek-moe-16b, the port's params cast to f32, T 4) on the per-leaf
reference route and the pooled route.  Against one process: the curves
within rtol 1e-5; the round's gradient (the delayed buffer after round 0)
within 1e-5 relative L2 per leaf on the reference route, whose buffer is
f32, and within 1e-4 on the pooled route, whose buffer is the bf16 pool
(the port's param specs are bf16, so a summation order's rounding flips
a few bf16 entries by an ulp: 1.3e-5 measured).  After one SGD step on
the reference route (two rounds: the delayed buffer of round 0, clipped
by the global norm over the ranks' blocks, then applied) the final state
holds within 1e-5 relative L2 per leaf (at lr 1, so that the step moves
every weight by 4e-5 to 1e-2 relative L2); after four Adam rounds the
final params are held within 1e-4 relative L2 per leaf and the
attention key bias within 1e-2, the bounds of
``tests/test_torch_dp_ranks.py`` (its gradient nearly cancels, and Adam
turns rounding into lr-sized steps); the MoE's final state within
1e-3, the bound of ``tests/test_torch_dp_jax.py`` after Adam rounds (its
last buffer, the gradient of round 3, is taken at params that Adam moved
by lr-sized steps where near-zero gradients change sign between summation
orders: 1.7e-4 measured on the attention norm).  The MoE on a mesh with two
data ranks dispatches in JAX's two groups, so there it is held to the
port's data-parallel run on ``(data 2, model 1)``, not to one process.
The lock-step ``Server`` on each mesh gives one process's greedy tokens
from the same prefilled prompts, for both families (the MoE on the data-1
meshes: its capacity couples a decode step's rows, so data ranks change
its dispatch).  A per-leaf checkpoint written at model 2 holds the whole
leaves and restores on one process bit for bit, and one written by one
process restores at model 2 into each rank's blocks bit for bit.
``ServeBackend(mesh=)`` at model 2 gives one process's token matrix.  A
round's collectives at model 2 (``distributed.collectives``' counters,
which ``TrainerBackend``'s ``extra["collectives"]`` reads, and
``launch/op_cost.py``'s tally) equal the hand count.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                           # noqa: E402
from torch_parity import rel_l2                                # noqa: E402

#: world size → the meshes its ranks run, in turn
WORLDS = {2: ({"data": 1, "model": 2}, {"data": 2, "model": 1}),
          4: ({"data": 2, "model": 2}, {"data": 1, "model": 4})}
TRAIN = ("dense_reference", "dense_pooled", "moe_reference", "moe_pooled")
#: one SGD step on the reference route: the case whose model and batches
#: it takes, its rounds and its lr (at lr 1 the clipped step of norm 1
#: moves every weight matrix by 1e-4 to 1e-2 relative L2, well above the
#: bound)
SGD = {"dense_sgd": ("dense_reference", 2, 1.0),
       "moe_sgd": ("moe_reference", 2, 1.0)}
MESH_CASES = [(m, n) for w in (2, 4) for m in WORLDS[w]
              if m["model"] > 1 for n in TRAIN]
SERVE_B, SERVE_S, SERVE_T, SERVE_CTX = 4, 12, 6, 24


def _key(mesh):
    return "x".join(f"{k}{v}" for k, v in mesh.items())


def _params(name):
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    tr = D.port_trainer(name, None)
    return tree_map(lambda p: p.float(), M.init_params(tr.cfg, 0, "cpu"))


def _serve(arch, mesh=None):
    """Greedy tokens: the prompts prefilled (the rank's rows, under the
    mesh's context), then ``SERVE_T`` decode steps."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import Server, ServeConfig
    from repro_torch.distributed.sharding import sharded_trace
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = get_arch(arch).reduced().with_(dtype="float32", remat="none")
    server = Server(cfg, ServeConfig(batch=SERVE_B, ctx_len=SERVE_CTX),
                    device="cpu", mesh=mesh)
    params = tree_map(lambda p: p.float(), M.init_params(cfg, 0, "cpu"))
    tokens = torch.from_numpy(D.tokens(cfg.vocab, SERVE_B, SERVE_S, 7)).long()
    pre = M.prefill
    if mesh is not None:
        params = tree_map(lambda t, sh: sh.local(t), params,
                          server.param_shardings())
        tokens = server.batch_sharding().local(tokens)
        pre = sharded_trace(M.prefill, mesh)
    with torch.no_grad():
        last, cache = pre(cfg, params, {"tokens": tokens}, ctx_len=SERVE_CTX)
        first = last.argmax(-1)
        if mesh is not None:
            first = server.batch_sharding().gather(first)
        toks = server.generate(params, first.numpy(), SERVE_T,
                               start_pos=SERVE_S, cache=cache)
    return np.concatenate([first.numpy()[:, None], toks], 1)


def _serve_archs(mesh):
    return ("qwen2-0.5b",) if mesh["data"] > 1 else \
        ("qwen2-0.5b", "deepseek-moe-16b")


def _checkpoints(mesh, out_dir):
    """A per-leaf state saved at model 2 and the whole state it holds; a
    one-process state's file restored into this rank's blocks."""
    from repro_torch import checkpoint
    from repro_torch.models.convert import params_to_numpy

    tr = D.port_trainer("dense_reference", mesh)
    sh = tr.state_shardings()
    state = tr.init_state(params=_params("dense_reference"))
    step = tr.train_step_fn()
    for q in range(2):
        state, _ = step(state, {"tokens": torch.from_numpy(D.tokens(
            tr.cfg.vocab, 8, 16, q)).long()}, torch.from_numpy(D.mask(4, q)))
    path = os.path.join(out_dir, "ckpt_tp")
    checkpoint.save(path, state, step=2, shardings=sh)
    whole = params_to_numpy(D.gathered(tr, state))
    one = D.port_trainer("dense_reference", None)
    one_state = one.init_state(params=_params("dense_reference"))
    one_path = os.path.join(out_dir, "ckpt_one")
    if mesh.rank == 0:
        checkpoint.save(one_path, one_state, step=0)
    torch.distributed.barrier()
    back = checkpoint.restore(one_path, tr.init_state(
        params=_params("dense_reference")), shardings=sh)
    from repro_torch.tree import tree_map
    blocks = tree_map(lambda t, s: s.local(t), one_state, sh)
    same = all(torch.equal(a, b) for a, b in zip(
        _leaves(back).values(), _leaves(blocks).values()))
    return {"path": path, "whole": whole, "restored_blocks_equal": same}


def _leaves(tree):
    from repro_torch.tree import tree_leaves_with_path
    return dict(tree_leaves_with_path(tree))


def _collectives(mesh):
    """One round's collectives at model 2 on the per-leaf reference route,
    counted by the module's counters and by op_cost's tally."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch import op_cost

    tr = D.port_trainer("dense_reference", mesh)
    state = tr.init_state(params=_params("dense_reference"))
    step = tr.train_step_fn()
    batch = {"tokens": torch.from_numpy(D.tokens(tr.cfg.vocab, 8, 16,
                                                 0)).long()}
    mask = torch.from_numpy(D.mask(4, 0))
    state, _ = step(state, batch, mask)
    before = C.snapshot()
    cost = op_cost.analyze(step, state, batch, mask)
    return {"counted": C.since(before), "bytes": cost.collective_bytes,
            "breakdown": dict(cost.collective_breakdown)}


def _serve_backend(mesh=None):
    """``ServeBackend``'s lock-step lane on reduced qwen2-0.5b (f32
    activations): its token matrix and, over a mesh, its collectives."""
    from repro_torch.api import ExperimentSpec, ServeBackend, ServeJob

    res = ServeBackend("cpu", mesh=mesh).run(ExperimentSpec(
        objective=ServeJob(batch=2, prompt_len=8, arch_overrides=(
            ("dtype", "float32"),)), T=5))
    return res.x, res.extra.get("collectives"), res.extra.get("mesh")


def _ranks(rank, world, out_dir):
    from repro_torch.launch.mesh import ProcessMesh

    out = {}
    for shape in WORLDS[world]:
        mesh = ProcessMesh(shape)
        key = _key(shape)
        names = TRAIN if shape["model"] > 1 else ("moe_reference",
                                                  "moe_pooled")
        for name in names:
            out[key, name] = D.port_case(name, mesh, _params(name))
        for name, (case, rounds, lr) in SGD.items():
            if shape["model"] > 1 or name.startswith("moe"):
                out[key, name] = D.port_case(case, mesh, _params(case),
                                             opt="sgd", rounds=rounds, lr=lr)
        if shape["model"] > 1:
            for arch in _serve_archs(shape):
                out[key, "serve", arch] = _serve(arch, mesh)
        if shape == {"data": 1, "model": 2}:
            out["ckpt"] = _checkpoints(mesh, out_dir)
            out["collectives"] = _collectives(mesh)
            out["serve_backend"] = _serve_backend(mesh)
    if rank == 0:
        with open(os.path.join(out_dir, "port.pkl"), "wb") as f:
            pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds side by side, and one process's runs meanwhile."""
    tmp = tmp_path_factory.mktemp("tp_ranks")
    started = [D.start(_ranks, w, tmp) for w in WORLDS]
    one = {name: D.port_case(name, None, _params(name)) for name in TRAIN}
    for name, (case, rounds, lr) in SGD.items():
        one[name] = D.port_case(case, None, _params(case), opt="sgd",
                                rounds=rounds, lr=lr)
    for arch in ("qwen2-0.5b", "deepseek-moe-16b"):
        one["serve", arch] = _serve(arch)
    one["serve_backend"] = _serve_backend()
    port = {}
    for s in started:
        with open(os.path.join(D.join(s), "port.pkl"), "rb") as f:
            port.update(pickle.load(f))
    return one, port


def _want(one, port, mesh, name):
    """What ``name`` on ``mesh`` is held to: one process, or for the MoE
    with two data ranks the port's run on (data 2, model 1)."""
    if name.startswith("moe") and mesh["data"] > 1:
        return port[_key({"data": mesh["data"], "model": 1}), name]
    return one[name]


def _f32(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _ids(cases):
    return [f"{_key(m)}-{n}" for m, n in cases]


@pytest.mark.parametrize("mesh,name", MESH_CASES, ids=_ids(MESH_CASES))
def test_curves_equal_one_process(runs, mesh, name):
    one, port = runs
    np.testing.assert_allclose(port[_key(mesh), name][0],
                               _want(one, port, mesh, name)[0], rtol=1e-5)


@pytest.mark.parametrize("mesh,name", MESH_CASES, ids=_ids(MESH_CASES))
def test_round_grads_equal_one_process_per_leaf(runs, mesh, name):
    one, port = runs
    got = _leaves(port[_key(mesh), name][1])
    want = _leaves(_want(one, port, mesh, name)[1])
    assert sorted(got) == sorted(want)
    bound = 1e-5 if name.endswith("reference") else 1e-4
    for path, w in want.items():
        assert rel_l2(_f32(got[path]), _f32(w)) <= bound, path


@pytest.mark.parametrize("mesh,name", MESH_CASES, ids=_ids(MESH_CASES))
def test_final_state_equals_one_process(runs, mesh, name):
    one, port = runs
    got = _leaves(port[_key(mesh), name][2])
    want = _leaves(_want(one, port, mesh, name)[2])
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if got[path].shape != w.shape:
            # a pooled state's m, v and gbuf at two data ranks are in
            # JAX's (2, cols) layout; p holds the params in either
            assert "['pools']" in path and mesh["data"] > 1, path
            continue
        bound = 1e-2 if path.endswith("['bk']") else \
            1e-3 if name.startswith("moe") else 1e-4
        assert rel_l2(_f32(got[path]), _f32(w)) <= bound, path


SGD_CASES = [(m, n) for w in (2, 4) for m in WORLDS[w] if m["model"] > 1
             for n in SGD]


@pytest.mark.parametrize("mesh,name", SGD_CASES, ids=_ids(SGD_CASES))
def test_one_sgd_step_final_state_equals_one_process(runs, mesh, name):
    """The final state after one SGD step (params, and the delayed buffer
    of the second round) within 1e-5 relative L2 per leaf, and the curve
    within rtol 1e-5."""
    one, port = runs
    got, want = port[_key(mesh), name], _want(one, port, mesh, name)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    got, want = _leaves(got[2]), _leaves(want[2])
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert rel_l2(_f32(got[path]), _f32(w)) <= 1e-5, path


SERVE_CASES = [(m, a) for w in (2, 4) for m in WORLDS[w] if m["model"] > 1
               for a in _serve_archs(m)]


@pytest.mark.parametrize("mesh,arch", SERVE_CASES, ids=_ids(SERVE_CASES))
def test_server_greedy_tokens_equal_one_process(runs, mesh, arch):
    one, port = runs
    np.testing.assert_array_equal(port[_key(mesh), "serve", arch],
                                  one["serve", arch])


def test_checkpoint_at_model_2_restores_on_one_process(runs):
    """The file holds the whole leaves (the gathered state, byte for byte);
    one process restores it bit for bit; a one-process checkpoint restores
    into each rank's blocks bit for bit (checked on the ranks)."""
    from repro_torch import checkpoint
    from repro_torch.models.convert import params_to_numpy

    _, port = runs
    ck = port["ckpt"]
    tr = D.port_trainer("dense_reference", None)
    like = tr.init_state(params=_params("dense_reference"))
    back = params_to_numpy(checkpoint.restore(ck["path"], like))
    for path, want in _leaves(ck["whole"]).items():
        np.testing.assert_array_equal(_leaves(back)[path], want,
                                      err_msg=path)
    assert checkpoint.load_meta(ck["path"])["step"] == 2
    assert ck["restored_blocks_equal"]


def test_serve_backend_on_model_2_gives_one_process_tokens(runs):
    """``ServeBackend(mesh=)`` at (data 1, model 2): every rank returns the
    whole token matrix, equal to one process's, and reports the mesh and
    the tensor-parallel collectives it ran."""
    one, port = runs
    toks, coll, mesh = port["serve_backend"]
    np.testing.assert_array_equal(toks, one["serve_backend"][0])
    assert mesh == {"data": 1, "model": 2}
    assert coll["all_reduce"][0] > 0 and coll["all_gather"][0] > 0


def _hand_count():
    """One round at (data 1, model 2), reduced qwen2-0.5b in f32 on the
    per-leaf reference route: {kind: [calls, bytes]}."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    cfg = get_arch("qwen2-0.5b").reduced()
    B, S, d, L, f = 8, 16, cfg.d_model, cfg.n_layers, 4
    act = B * S * d * f
    # forward: the embedding's sum; per layer, attention and MLP each sum
    # their output and all-reduce their input's gradient in the backward;
    # the unembedding's input gradient; the CE's max, Σ exp and target
    # logit; the data group's mask total and reported loss; each grad
    # leaf over the (one-rank) data group; the clip norm's split squares
    reduce_calls = 1 + 4 * L + 1 + 3 + 2 + 14 + 1
    # every leaf of this config is split in two at model 2
    leaf_bytes = sum(int(np.prod(s.shape)) // 2 * f
                     for s in tree_leaves(M.param_specs(cfg)))
    reduce_bytes = (act + 4 * L * act + act + 3 * B * (S - 1) * f + f
                    + 3 * f + leaf_bytes + f)
    # the norm weights (split on embed) gathered: two a layer, the final
    gathers = 2 * L + 1
    return {"all_reduce": [reduce_calls, reduce_bytes],
            "all_gather": [gathers, gathers * d // 2 * f],
            "reduce_scatter": [0, 0]}


def test_a_rounds_collectives_equal_the_hand_count(runs):
    _, port = runs
    got = port["collectives"]
    want = _hand_count()
    assert got["counted"] == want
    assert got["bytes"] == sum(b for _, b in want.values())
    assert got["breakdown"].get("all-reduce", 0) == want["all_reduce"][1]
