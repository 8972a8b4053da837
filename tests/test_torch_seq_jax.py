"""The port's sequence-parallel trainer and prefill against the JAX
package under ``SEQ_PARALLEL_RULES`` on ``(data 1, model 4)``.

One JAX subprocess (``tests/torch_tp.py``, four forced host devices) runs
the JAX trainer's own compiled step under ``SEQ_PARALLEL_RULES`` for
``torch_dp.SEQ_CASES``: reduced qwen2-0.5b in f32 on the pooled route
(its 4 heads on the ranks' heads) and on the per-leaf route with 6 query
heads, which the model axis of 4 does not divide (the gathered attention
``auto_rules`` picks these rules for: q of each rank's rows against k / v
of the gathered sequence).  It also prefills each case's prompts on the
mesh under the rules and decodes them greedily with the JAX ``Server``.
The port's ranks, a gloo world of four spawned beside it, run the same
cases from the params the JAX subprocess draws first, each rank holding
its 4 of the 16 rows between blocks, and at (data 2, model 2) the
per-leaf route (each data rank's ZeRO blocks) against one process; the
same world serves the slot
lane (``ServeBackend``) under the rules, each admission's prefill split
over the model group, against one process's token matrix.  Tolerances,
those of ``tests/test_torch_tp_jax.py``: f32 curves within 1e-4
relative; one round's gradient (the delayed buffer after round 0) within
1.7e-4 relative L2 per leaf; the greedy tokens equal.

The round's sequence-parallel operators are counted against a hand count
(reduced qwen2-0.5b: 2 layers, a vocab-parallel embedding): on the ranks'
heads each layer gathers the rows before the attention and the MLP and
reduce-scatters after both, the embedding reduce-scatters and the logits
gather, so a forward holds 2·2 + 1 of each; with the attention leaves
gathered the attention gathers the rows for k / v and reduces nothing.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                           # noqa: E402
import torch_tp as TT                                          # noqa: E402
from torch_parity import rel_l2                                # noqa: E402

NAMES = ("dense_seq", "dense_seq_h6")
MESH = (1, 4)
ENTRIES = [f"{n}@{MESH[0]}x{MESH[1]}" for n in NAMES]
SERVED = ("serve_seq", "serve_seq_h6")
JAX_ENTRIES = ENTRIES + [f"{s}@1x4" for s in SERVED]
#: the sequence-parallel operators of one round, by hand (2 layers)
HAND = {"dense_seq": {"gather_seq": 2 * 2 + 1, "scatter_seq": 2 * 2 + 1},
        "dense_seq_h6": {"gather_seq": 2 * 2 + 1, "scatter_seq": 2 + 1}}


def _counted_round(name, mesh, params_paths):
    """One round of case ``name`` from the JAX params → (the
    sequence-parallel operators, the round's collectives by kind)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy

    arch, impl, mb, dtype, B, S, groups, T = D.ALL_CASES[name]
    params = D.unflatten(D.wait_params(params_paths)[name]["params"])
    tr = D.port_trainer(name, mesh)
    state = tr.init_state(params=params_from_numpy(params, "cpu"))
    step = tr.train_step_fn()
    b = {k: torch.from_numpy(v) for k, v in
         D.batch(tr.cfg, M.batch_specs(tr.cfg, B, S), 0).items()}
    b["tokens"] = b["tokens"].long()
    C.reset()
    step(state, b, torch.from_numpy(D.mask(groups, 0)))
    return dict(C.seq_launches), dict(C.launches)


def _slot_spec():
    """The slot lane's serve: reduced qwen2-0.5b in f32, 4 requests of
    8-token prompts over 2 slots (each admission's prefill splits its 8
    rows over the model axis of 4)."""
    from repro_torch.api import ExperimentSpec, ServeJob

    return ExperimentSpec(objective=ServeJob(
        n_slots=2, n_requests=4, prompt_len=8,
        arch_overrides=(("dtype", "float32"),)), T=6)


def _slot_lane(mesh):
    """(the token matrix, the sequence-parallel operators) of
    ``_slot_spec`` served by ``ServeBackend`` under SEQ_PARALLEL_RULES."""
    from repro_torch.api import ServeBackend
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import SEQ_PARALLEL_RULES

    C.reset()
    res = ServeBackend("cpu", mesh=mesh, rules=SEQ_PARALLEL_RULES).run(
        _slot_spec())
    return np.asarray(res.x), dict(C.seq_launches)


def _ranks(rank, world, out_dir, params_paths):
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.models.convert import params_from_numpy

    out = TT.trainer_ranks((MESH,), NAMES, params_paths)
    mesh = ProcessMesh({"data": MESH[0], "model": MESH[1]})
    for s in SERVED:
        out[s] = TT.port_serve(s, mesh, params_paths)
    for n in NAMES:
        out[f"count:{n}"] = _counted_round(n, mesh, params_paths)
    out["slot_lane"] = _slot_lane(mesh)
    # per-leaf ZeRO under the seq rules: (data 2, model 2)
    params = D.unflatten(D.wait_params(params_paths)["dense_seq_h6"]["params"])
    zero = ProcessMesh({"data": 2, "model": 2})
    out["zero@2x2"] = (
        D.port_case("dense_seq_h6", zero, params_from_numpy(params, "cpu"))[0],
        D.port_trainer("dense_seq_h6", zero).zero is not None)
    if rank == 0:
        with open(os.path.join(out_dir, "port.pkl"), "wb") as f:
            pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_jax")
    out, params = str(tmp / "jax.npz"), str(tmp / "params.npz")
    proc = TT.start_jax(out, params, JAX_ENTRIES)
    try:
        done = D.join(D.start(_ranks, 4, tmp / "w4", [params]),
                      alive=lambda: proc.poll() in (None, 0))
    finally:
        D.wait_jax([proc])
    with open(os.path.join(done, "port.pkl"), "rb") as f:
        port = pickle.load(f)
    return TT.results(out), port, params


def _f32(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


@pytest.mark.parametrize("entry", ENTRIES)
def test_curves_match_jax_under_the_seq_rules(runs, entry):
    jres, port, _ = runs
    np.testing.assert_allclose(port[entry]["case"][0],
                               jres[entry]["losses"], rtol=1e-4)


@pytest.mark.parametrize("entry", ENTRIES)
def test_one_round_grads_match_jax_per_leaf(runs, entry):
    from repro_torch.tree import tree_leaves_with_path

    jres, port, _ = runs
    got = dict(tree_leaves_with_path(port[entry]["case"][1]))
    assert sorted(got) == sorted(jres[entry]["grads"])
    for path, want in jres[entry]["grads"].items():
        assert rel_l2(_f32(got[path]), _f32(want)) <= 1.7e-4, path


@pytest.mark.parametrize("entry", ENTRIES)
def test_jax_state_crosses_to_the_ranks_and_back_bitwise(runs, entry):
    from repro_torch.tree import tree_leaves_with_path

    jres, port, _ = runs
    mine = dict(tree_leaves_with_path(port[entry]["jax_state"]))
    for path, want in jres[entry]["first"].items():
        np.testing.assert_array_equal(np.asarray(mine[path]), want,
                                      err_msg=path)
    assert port[entry]["round_trip"]


@pytest.mark.parametrize("served", SERVED)
def test_prefill_tokens_match_the_jax_server(runs, served):
    jres, port, _ = runs
    assert port[served]["round_trip"]
    np.testing.assert_array_equal(port[served]["tokens"],
                                  jres[f"{served}@1x4"]["tokens"])


def test_slot_lane_admissions_prefill_seq_split_and_match_one_process(runs):
    """Each of the 4 admissions' prefills on the model group takes the
    seq split: 2 layers × 2 gathers (the prefill's last row is gathered
    without one) and 2 × 2 + 1 reduce-scatters (with the embedding's);
    the token matrix is one process's."""
    from repro_torch.api import ServeBackend

    _, port, _ = runs
    tokens, seq = port["slot_lane"]
    want = np.asarray(ServeBackend("cpu").run(_slot_spec()).x)
    np.testing.assert_array_equal(tokens, want)
    assert seq == {"gather_seq": 4 * 2 * 2, "scatter_seq": 4 * (2 * 2 + 1)}


def test_per_leaf_zero_under_the_seq_rules_equals_one_process(runs):
    """At (data 2, model 2) the per-leaf route holds ZeRO blocks over the
    data ranks and splits the rows over the model ranks; its curve is one
    process's (1e-5, the tensor-parallel ranks' tolerance)."""
    from repro_torch.models.convert import params_from_numpy

    _, port, params_path = runs
    losses, zero = port["zero@2x2"]
    params = D.unflatten(D.wait_params([params_path])["dense_seq_h6"][
        "params"])
    want = D.port_case("dense_seq_h6", None,
                       params_from_numpy(params, "cpu"))[0]
    assert zero
    np.testing.assert_allclose(losses, want, rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_round_seq_operators_equal_the_hand_count(runs, name):
    _, port, _ = runs
    seq, coll = port[f"count:{name}"]
    assert seq == HAND[name]
    # each operator's forward collective, and its backward's
    assert coll["all_gather"] >= seq["gather_seq"] + seq["scatter_seq"]
    assert coll["reduce_scatter"] >= seq["gather_seq"] + seq["scatter_seq"]
