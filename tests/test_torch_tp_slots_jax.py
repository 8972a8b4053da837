"""The slot lane over a mesh against the JAX ``SlotServer`` on the same mesh.

One JAX subprocess (``tests/torch_tp_slots.py``, four forced host
devices) draws the params of the four families' reduced f32 configs, then
serves each on the meshes (data, model) = (2, 2) and (1, 2) with the JAX
``SlotServer`` (its lanes over the data axis, its params and ragged cache
under the rules).  The port's gloo ranks, spawned beside it, wait for
those params and serve the same requests with ``SlotServer(mesh=...)``,
each rank on its blocks.  The greedy tokens and the TTFT are equal, on
every rank.  This includes the MoE at two data ranks, whose decode steps
dispatch in two groups of four rows there (its eight slots over two data
ranks, as many rows as experts), where one process would dispatch one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                           # noqa: E402
import torch_tp_slots as TS                                    # noqa: E402

ENTRIES = [f"{f}@{d}x{m}" for f in TS.FAMILIES for d, m in ((2, 2), (1, 2))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_slots_jax")
    out, params = str(tmp / "jax.npz"), str(tmp / "params.npz")
    proc = TS.start_jax(out, params, ENTRIES)
    try:
        port = TS.join_ranks(TS.start_ranks(tmp, ENTRIES, [params]),
                             alive=lambda: proc.poll() in (None, 0))
    finally:
        D.wait_jax([proc])
    data = np.load(out)
    return {k: data[k] for k in data.files}, port


@pytest.mark.parametrize("entry", ENTRIES)
def test_slot_tokens_match_jax_on_the_mesh(runs, entry):
    jres, port = runs
    fam, d, m = TS.parse(entry)
    got = port[entry]
    assert len(got) == d * m
    want = jres[f"{entry}/tokens"]
    assert (want >= 0).all()
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["tokens"], want,
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(res["ttft_steps"],
                                      jres[f"{entry}/ttft_steps"])
