"""Per-leaf ZeRO's layout against the JAX trainer's, ranked checkpoints
across both packages, and the dry-run's state bytes.

A JAX subprocess on four forced host devices (``tests/torch_tp.py``,
``specs@DxM`` entries) dumps the JAX ``AsyncTrainer.state_shardings()``
(its default ``fsdp_params=True``) of one per-leaf case of each of the six
families (``torch_tp.SPEC_CASES``: reduced configs, f32) on ``(data 2,
model 1)`` and ``(data 2, model 2)``.  Gloo worlds of two and four ranks
(``tests/torch_dp.py``) build the port's trainer of each case on the same
mesh: every leaf's ``PSpec`` equals the JAX one; each leaf the rank holds,
drawn from a seed or cut from the whole params, has exactly
``local_state_specs()``'s shape and is contiguous (the update kernels
refuse anything else); the ranks' blocks gathered are one process's state
bit for bit.

Checkpoints, on both meshes (reduced qwen2-0.5b in f32 on the fused
per-leaf route): the JAX checkpointer's file of the JAX trainer's initial
state, restored with the port's ``shardings=``, gives each rank its blocks
bit for bit; four rounds from it equal two rounds, a ranked save, a
restore and two more, bit for bit; the ranked save of the final state is
the file rank 0 writes of the gathered state, byte for byte, and the JAX
checkpointer restores it.

The dry-run: on a rank of ``32x8``, every arch's ``train_4k`` state as
``local_state_specs()`` gives it sums to ``analytic_state_bytes``, and the
traced qwen2-0.5b record's ``traced_state_bytes`` equal them.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                           # noqa: E402
import torch_tp as TT                                          # noqa: E402

WORLDS = {2: {"data": 2, "model": 1}, 4: {"data": 2, "model": 2}}
CKPT_CASE = "dense_pallas"


def _key(mesh):
    return f"{mesh['data']}x{mesh['model']}"


def _params(name):
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    tr = D.port_trainer(name, None)
    return tree_map(lambda p: p.float(), M.init_params(tr.cfg, 0, "cpu"))


def _np(tree):
    from repro_torch.models.convert import params_to_numpy
    return params_to_numpy(tree)


def _layout(mesh):
    """Each case's specs, shapes and gathered states on ``mesh``."""
    from repro_torch.models.specs import Spec
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    out = {}
    for name in TT.SPEC_CASES:
        tr = D.port_trainer(name, mesh)
        specs = dict(tree_leaves_with_path(tr.state_specs()))
        local = [s.shape for s in tree_leaves(tr.local_state_specs())
                 if isinstance(s, Spec)]
        res = {"specs": {p: TT.spec_str(sh.spec, len(specs[p].shape))
                         for p, sh in
                         tree_leaves_with_path(tr.state_shardings())}}
        for how, state in (("params", tr.init_state(params=_params(name))),
                           ("seed", tr.init_state(0))):
            leaves = tree_leaves(state)
            res[how] = {
                "shapes": [tuple(t.shape) for t in leaves] == local,
                "contiguous": all(t.is_contiguous() for t in leaves),
                "whole": _np(D.gathered(tr, state))}
        out[name] = res
    return out


def _rounds(tr, step, state, lo, hi):
    from repro_torch.models import model as M

    for q in range(lo, hi):
        b = D.batch(tr.cfg, M.batch_specs(tr.cfg, 8, 16), q)
        state, _ = step(state, {"tokens": torch.from_numpy(
            b["tokens"]).long()}, torch.from_numpy(D.mask(4, q)))
    return state


def _checkpoints(mesh, out_dir, jax_ckpt):
    from repro_torch import checkpoint
    from repro_torch.tree import tree_leaves, tree_map

    params = _params(CKPT_CASE)
    tr = D.port_trainer(CKPT_CASE, mesh)
    sh = tr.state_shardings()
    step = tr.train_step_fn()
    jax_state = TT.jax_state(D.port_trainer(CKPT_CASE, None), _np(params))

    def from_jax():
        return checkpoint.restore(jax_ckpt, tr.init_state(params=params),
                                  shardings=sh)

    back = from_jax()
    want = tree_map(lambda a, s: torch.from_numpy(
        np.array(s.local(np.asarray(a)))), jax_state, sh)
    blocks = all(torch.equal(a, b) and a.is_contiguous()
                 for a, b in zip(tree_leaves(back), tree_leaves(want)))
    whole = _rounds(tr, step, back, 0, 4)
    half = os.path.join(out_dir, "ckpt_half")
    checkpoint.save(half, _rounds(tr, step, from_jax(), 0, 2), step=2,
                    shardings=sh)
    resumed = _rounds(tr, step, checkpoint.restore(
        half, tr.init_state(params=params), shardings=sh), 2, 4)
    full = D.gathered(tr, whole)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(D.gathered(tr, resumed)), tree_leaves(full)))
    checkpoint.save(os.path.join(out_dir, "ckpt_ranked"), whole, step=4,
                    shardings=sh)
    if mesh.rank == 0:
        checkpoint.save(os.path.join(out_dir, "ckpt_gathered"), full,
                        step=4)
    return {"blocks": blocks, "same": same, "out_dir": out_dir}


def _ranks(rank, world, out_dir, jax_ckpt):
    from repro_torch.launch.mesh import ProcessMesh

    mesh = ProcessMesh(WORLDS[world])
    out = {"layout": _layout(mesh),
           "ckpt": _checkpoints(mesh, out_dir, jax_ckpt)}
    if rank == 0:
        with open(os.path.join(out_dir, "port.pkl"), "wb") as f:
            pickle.dump(out, f)


def _write_jax_checkpoint(path):
    """The JAX trainer's initial state of :data:`CKPT_CASE` (one process),
    written by the JAX package's checkpointer."""
    import jax
    import jax.numpy as jnp

    import repro.checkpoint as jckpt

    state = TT.jax_state(D.port_trainer(CKPT_CASE, None),
                         _np(_params(CKPT_CASE)))
    jckpt.save(path, jax.tree_util.tree_map(jnp.asarray, state), step=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and both worlds side by side; one process's
    states meanwhile."""
    tmp = tmp_path_factory.mktemp("zero_layout")
    jax_out = str(tmp / "jax.npz")
    proc = TT.start_jax(jax_out, str(tmp / "params.npz"),
                        [f"specs@{_key(m)}" for m in WORLDS.values()])
    jax_ckpt = str(tmp / "jax_ckpt")
    _write_jax_checkpoint(jax_ckpt)
    alive = lambda: proc.poll() in (None, 0)
    try:
        started = {w: D.start(_ranks, w, tmp / f"w{w}", jax_ckpt)
                   for w in WORLDS}
        one = {}
        for name in TT.SPEC_CASES:
            tr = D.port_trainer(name, None)
            one[name] = {"params": _np(tr.init_state(params=_params(name))),
                         "seed": _np(tr.init_state(0))}
        port = {}
        for w, st in started.items():
            with open(os.path.join(D.join(st, alive=alive), "port.pkl"),
                      "rb") as f:
                port[_key(WORLDS[w])] = pickle.load(f)
    finally:
        D.wait_jax([proc])
    return TT.results(jax_out), port, one


def _leaves(tree):
    from repro_torch.tree import tree_leaves_with_path
    return dict(tree_leaves_with_path(tree))


LAYOUT = [(_key(m), n) for m in WORLDS.values() for n in TT.SPEC_CASES]


@pytest.mark.parametrize("mesh,name", LAYOUT,
                         ids=[f"{m}-{n}" for m, n in LAYOUT])
def test_state_specs_equal_the_jax_trainers(runs, mesh, name):
    jres, port, _ = runs
    want = {k: str(v) for k, v in jres[f"specs@{mesh}"][name].items()}
    got = port[mesh]["layout"][name]["specs"]
    assert got == want
    # over data ranks every per-leaf state leaf that a rule divides is
    # split on the data axes: ZeRO, not replication
    assert any("'data'" in s for p, s in got.items()
               if p.startswith("['opt']['m']"))


@pytest.mark.parametrize("how", ["params", "seed"])
@pytest.mark.parametrize("mesh,name", LAYOUT,
                         ids=[f"{m}-{n}" for m, n in LAYOUT])
def test_ranks_hold_their_blocks_and_gather_to_one_process(runs, mesh, name,
                                                           how):
    _, port, one = runs
    res = port[mesh]["layout"][name][how]
    assert res["shapes"] and res["contiguous"]
    got, want = _leaves(res["whole"]), _leaves(one[name][how])
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and np.array_equal(got[path], w), \
            path


@pytest.mark.parametrize("mesh", [_key(m) for m in WORLDS.values()])
def test_checkpoints_cross_both_packages_and_resume_bitwise(runs, mesh):
    import jax.numpy as jnp

    from repro import checkpoint as jckpt

    ck = runs[1][mesh]["ckpt"]
    assert ck["blocks"] and ck["same"]
    ranked = np.load(os.path.join(ck["out_dir"], "ckpt_ranked", "state.npz"))
    gathered = np.load(os.path.join(ck["out_dir"], "ckpt_gathered",
                                    "state.npz"))
    assert sorted(ranked.files) == sorted(gathered.files)
    for k in ranked.files:
        assert ranked[k].dtype == gathered[k].dtype
        assert ranked[k].tobytes() == gathered[k].tobytes(), k
    like = TT.jax_state(D.port_trainer(CKPT_CASE, None),
                        _np(_params(CKPT_CASE)))
    back = jckpt.restore(os.path.join(ck["out_dir"], "ckpt_ranked"),
                         _tree_jnp(like, jnp))
    for path, a in _leaves(_tree_np(back)).items():
        np.testing.assert_array_equal(a, ranked[path], err_msg=path)
    assert int(back["step"]) == 4


def _tree_jnp(tree, jnp):
    return {k: _tree_jnp(v, jnp) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_every_archs_rank_state_is_the_analytic_zero_bytes():
    """No trace: the specs of a ``32x8`` rank's train state against the
    rules' analytic bytes, for every arch of the registry."""
    from repro_torch.configs import ARCHS, SHAPES, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import TracedMesh
    from repro_torch.models.specs import torch_dtype
    from repro_torch.tree import tree_leaves

    whole = dryrun.RANK_MESHES["32x8"]
    shape = SHAPES["train_4k"]
    for arch in sorted(ARCHS):
        cfg = dryrun.arch_for_shape(get_arch(arch), shape)
        tr = dryrun._trainer(cfg, "meta", mesh=TracedMesh(whole.shape))
        sp = tr.local_state_specs()
        held = sum(int(np.prod(s.shape)) * torch_dtype(s.dtype).itemsize
                   for t in (sp["params"], sp["opt"]["m"], sp["opt"]["v"],
                             sp["gbuf"]) for s in tree_leaves(t))
        assert held == dryrun.state_bytes(cfg, shape, whole), arch


def test_a_traced_train_record_holds_its_zero_blocks():
    from repro_torch.launch import dryrun

    rec = dryrun.run_one("qwen2-0.5b", "train_4k", mesh="32x8",
                         verbose=False)
    assert rec["ok"], rec.get("error")
    assert rec["traced_state_bytes"] == rec["analytic_state_bytes"]
    assert rec["op_cost"]["collective_breakdown"]["reduce-scatter"] > 0
