"""The ssm and hybrid families tensor-parallel, against the JAX package on
the same meshes (the audio and vlm families: ``tests/
test_torch_tp_modal_jax.py``).

Two JAX subprocesses (``tests/torch_tp.py``, four forced host devices, one
per family) run the JAX trainer's own compiled step on the meshes
``(data 2, model 2)`` and ``(data 1, model 4)`` for the f32 cases of
reduced mamba2-370m and zamba2-7b (three layers: one group of two and a
one-layer tail) on the reference and pooled routes, and the JAX
``Server`` on ``(data 1, model 2)`` and ``(data 1, model 4)`` (the same
configs in f32, prefilled prompts, greedy).  The port's ranks, spawned
over gloo beside them, run the same cases from the params the JAX
subprocesses draw first: a world of four on both trainer meshes and
serving at model 4, a world of two serving at model 2.  Tolerances, those
of ``tests/test_torch_tp_jax.py``: f32 curves within 1e-4 relative; one
round's gradient (the delayed buffer after round 0) within 1.7e-4
relative L2 per leaf.  The servers' greedy tokens are equal.

Checkpoints cross both ways bit for bit at (data 1, model 4): the JAX
package's checkpointer writes the JAX trainer's initial state of each
reference case, the ranks restore it into their blocks (equal to
``NamedSharding.local`` of that state), train two rounds and save with
their shardings, and the JAX checkpointer restores that file equal to the
ranks' gathered state.  The JAX params cross as each rank's blocks
(``params_blocks``) and gather back bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp as TT                                          # noqa: E402
from torch_parity import rel_l2                                # noqa: E402

FAMILIES = ("ssm", "hybrid")
ENTRIES, SERVED, _ = TT.family_entries(FAMILIES)
CKPTS = tuple(f"{f}_reference" for f in FAMILIES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return TT.run_families(tmp_path_factory.mktemp("tp_families_jax"),
                           FAMILIES, CKPTS)


def _f32(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _leaves(tree):
    from repro_torch.tree import tree_leaves_with_path
    return dict(tree_leaves_with_path(tree))


@pytest.mark.parametrize("entry", ENTRIES)
def test_curves_match_jax_on_the_mesh(runs, entry):
    jres, port = runs
    np.testing.assert_allclose(port[entry]["case"][0],
                               jres[entry]["losses"], rtol=1e-4)


@pytest.mark.parametrize("entry", ENTRIES)
def test_one_round_grads_match_jax_per_leaf(runs, entry):
    jres, port = runs
    got = _leaves(port[entry]["case"][1])
    assert sorted(got) == sorted(jres[entry]["grads"])
    for path, want in jres[entry]["grads"].items():
        assert rel_l2(_f32(got[path]), _f32(want)) <= 1.7e-4, path


@pytest.mark.parametrize("entry", ENTRIES)
def test_jax_state_crosses_to_the_ranks_and_back_bitwise(runs, entry):
    jres, port = runs
    mine = _leaves(port[entry]["jax_state"])
    for path, want in jres[entry]["first"].items():
        np.testing.assert_array_equal(np.asarray(mine[path]), want,
                                      err_msg=path)
    assert port[entry]["round_trip"]


@pytest.mark.parametrize("entry", SERVED)
def test_server_tokens_match_jax(runs, entry):
    jres, port = runs
    np.testing.assert_array_equal(port[entry]["tokens"],
                                  jres[entry]["tokens"])
    assert port[entry]["round_trip"]


@pytest.mark.parametrize("name", CKPTS)
def test_ranked_checkpoints_cross_the_jax_format_both_ways(runs, name):
    import jax
    import jax.numpy as jnp

    import repro.checkpoint as jckpt

    _, port = runs
    ck = port[f"ckpt:{name}"]
    assert ck["restored_blocks_equal"]
    like = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, jnp.bfloat16 if a.dtype == np.uint16
                            else a.dtype), ck["whole"])
    got = _leaves(jax.tree_util.tree_map(np.asarray,
                                         jckpt.restore(ck["path"], like)))
    for path, want in _leaves(ck["whole"]).items():
        have = got[path]
        if have.dtype.name == "bfloat16":
            have = have.view(np.uint16)
        assert have.dtype == want.dtype, path
        np.testing.assert_array_equal(have, want, err_msg=path)
    assert jckpt.load_meta(ck["path"])["step"] == 2
