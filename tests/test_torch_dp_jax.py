"""The port's data-parallel trainer against the JAX trainer on the same mesh.

Two subprocesses, the dense cases in one and the MoE's in the other, run
the JAX trainer's own compiled step (``jit_train_step``, the state on its
shardings) on a ``(data 2, model 1)`` mesh of forced host devices
(``tests/torch_dp.py``, as ``tests/test_pool_multidevice.py`` forces its
devices); two port ranks spawned over gloo run the same cases from the same
params, tokens and masks (``torch_dp.CASES``): reduced qwen2-0.5b and
deepseek-moe-16b in f32 on the reference and pooled routes, the pooled
route at ``microbatches=2``, the MoE where JAX falls back to one dispatch
group (each rank holds fewer tokens than there are experts), and the bf16
main path. Tolerances: f32 curves within 1e-4 relative; one round's
gradient (the delayed buffer after round 0) within 1.7e-4 relative L2 per
leaf, the bound of the port's grads against ``jax.grad`` (ROADMAP.md queue
3), which an MoE aux term counted once per rank would break; the final f32
params within 1e-3 relative L2 per leaf, ``tests/test_torch_family_train.py``'s
bound after Adam rounds (entries whose gradients are ~1e-9 change sign
between the frameworks and move lr apart), and the attention key bias
within 1e-2, ``tests/test_torch_faults.py``'s (its gradient is zero in
exact arithmetic); the pools' layout bit for bit, both packages at n_shards
2; the bf16 curve within the JAX suite's 5e-3
(``tests/test_pool_multidevice.py``). The JAX side runs at XLA's backend
optimisation level 0, which halves its compile time and moves its f32
curves by under 1e-5 relative.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                           # noqa: E402
from torch_parity import rel_l2                                # noqa: E402

F32_CASES = [n for n, c in D.CASES.items() if c[3] == "float32"]
POOLED = [n for n, c in D.CASES.items() if c[1] == "pallas_pooled"]


def _ranks(rank, world, out_dir, params_paths):
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.models.convert import params_from_numpy

    mesh = ProcessMesh({"data": 2, "model": 1})
    res = D.wait_params(params_paths)
    out = {}
    for name in D.CASES:
        params = params_from_numpy(D.unflatten(res[name]["params"]), "cpu")
        out[name] = D.port_case(name, mesh, params)
    if rank == 0:
        with open(os.path.join(out_dir, "port.pkl"), "wb") as f:
            pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocesses and the port's two ranks run side by side,
    from the params the JAX subprocesses draw first."""
    tmp = tmp_path_factory.mktemp("dp_jax")
    paths = [(str(tmp / f"jax{i}.npz"), str(tmp / f"params{i}.npz"))
             for i in range(len(D.JAX_GROUPS))]
    procs = [D.start_jax(out, params, names)
             for (out, params), names in zip(paths, D.JAX_GROUPS)]
    try:
        out = D.join(D.start(_ranks, 2, tmp, [p for _, p in paths]),
                     alive=lambda: all(p.poll() in (None, 0) for p in procs))
    finally:
        D.wait_jax(procs)
    with open(os.path.join(out, "port.pkl"), "rb") as f:
        port = pickle.load(f)
    jres = {}
    for jax_path, _ in paths:
        jres.update(D.jax_results(jax_path))
    return jres, port


def _leaves(tree):
    from repro_torch.tree import tree_leaves_with_path
    return dict(tree_leaves_with_path(tree))


def _f32(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:                 # bf16 bits
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


@pytest.mark.parametrize("name", list(D.CASES))
def test_curves_match_jax_on_the_mesh(runs, name):
    jres, port = runs
    tol = 1e-4 if D.CASES[name][3] == "float32" else 5e-3
    np.testing.assert_allclose(port[name][0], jres[name]["losses"],
                               rtol=tol)


@pytest.mark.parametrize("name", F32_CASES)
def test_one_round_grads_match_jax_per_leaf(runs, name):
    jres, port = runs
    got = _leaves(port[name][1])
    assert sorted(got) == sorted(jres[name]["grads"])
    for path, want in jres[name]["grads"].items():
        assert rel_l2(_f32(got[path]), _f32(want)) <= 1.7e-4, path


@pytest.mark.parametrize("name", F32_CASES)
def test_final_params_match_jax(runs, name):
    jres, port = runs
    final = _leaves(port[name][2])
    jfinal = jres[name]["final"]
    if D.CASES[name][1] == "pallas_pooled":
        from repro_torch.configs import get_arch
        from repro_torch.models import model as M
        from repro_torch.optim.pool import build_layout, unpool_tree

        lay = build_layout(M.param_specs(get_arch(D.CASES[name][0])
                                         .reduced()), 2)
        pick = lambda flat: _leaves(unpool_tree(lay, {
            dk: torch.from_numpy(_f32(flat[f"['pools']['{dk}']['p']"]))
            for dk in lay.groups}))
        got, want = pick(final), pick(jfinal)
    else:
        got = {k: v for k, v in final.items() if k.startswith("['params']")}
        want = {k: v for k, v in jfinal.items()
                if k.startswith("['params']")}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        bound = 1e-2 if path.endswith("['bk']") else 1e-3
        assert rel_l2(_f32(got[path]), _f32(w)) <= bound, path


@pytest.mark.parametrize("name", POOLED)
def test_pool_layout_bitwise_at_two_shards(runs, name):
    """Both packages' pooled states at n_shards 2: the initial pools equal
    bit for bit (p from the same params, zero m, v and gbuf), and the
    final pools have JAX's shapes and dtypes."""
    jres, port = runs
    first, final = _leaves(port[name][3]), _leaves(port[name][2])
    for path, want in jres[name]["first"].items():
        if not path.startswith("['pools']"):
            continue
        assert want.shape[0] == 2, path
        np.testing.assert_array_equal(first[path], want, err_msg=path)
        assert final[path].shape == jres[name]["final"][path].shape
        assert final[path].dtype == jres[name]["final"][path].dtype


def test_the_fallback_case_is_one_dispatch_group():
    """The fallback case gives each rank fewer tokens than experts, the
    dense cases at least as many as the experts would need."""
    from repro_torch.configs import get_arch

    arch, _, _, _, B, S, _, _ = D.CASES["moe_fallback"]
    assert B // 2 * S < get_arch(arch).reduced().n_experts
    arch, _, _, _, B, S, _, _ = D.CASES["moe_pooled"]
    assert B // 2 * S >= get_arch(arch).reduced().n_experts
