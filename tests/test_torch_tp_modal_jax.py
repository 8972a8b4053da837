"""The audio and vlm families tensor-parallel, against the JAX package on
the same meshes.

As ``tests/test_torch_tp_families_jax.py`` (its tests, run here on these
families; the helpers are ``tests/torch_tp.py``'s), for the f32 cases of
reduced seamless-m4t-large-v2 (frames through the encoder, its memory
cross-attended by every decoder layer) and pixtral-12b (patches
projected into the first positions), on the reference and pooled routes,
on ``(data 2, model 2)`` and ``(data 1, model 4)``: curves within 1e-4
relative, one round's gradient within 1.7e-4 relative L2 per leaf, the
JAX trainer's initial state across to the ranks and back bit for bit,
ranked checkpoints across the JAX format both ways bit for bit.  Neither
JAX ``Server`` serves these families here: the port's model-level serve
over a mesh is held to one process in
``tests/test_torch_tp_families_ranks.py``.  One JAX subprocess per
family.
"""
import pytest

pytest.importorskip("torch")

import test_torch_tp_families_jax as F                          # noqa: E402
import torch_tp as TT                                           # noqa: E402

FAMILIES = ("audio", "vlm")
ENTRIES, _, _ = TT.family_entries(FAMILIES)
CKPTS = tuple(f"{f}_reference" for f in FAMILIES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return TT.run_families(tmp_path_factory.mktemp("tp_modal_jax"),
                           FAMILIES, CKPTS)


@pytest.mark.parametrize("entry", ENTRIES)
def test_curves_match_jax_on_the_mesh(runs, entry):
    F.test_curves_match_jax_on_the_mesh(runs, entry)


@pytest.mark.parametrize("entry", ENTRIES)
def test_one_round_grads_match_jax_per_leaf(runs, entry):
    F.test_one_round_grads_match_jax_per_leaf(runs, entry)


@pytest.mark.parametrize("entry", ENTRIES)
def test_jax_state_crosses_to_the_ranks_and_back_bitwise(runs, entry):
    F.test_jax_state_crosses_to_the_ranks_and_back_bitwise(runs, entry)


@pytest.mark.parametrize("name", CKPTS)
def test_ranked_checkpoints_cross_the_jax_format_both_ways(runs, name):
    F.test_ranked_checkpoints_cross_the_jax_format_both_ways(runs, name)
