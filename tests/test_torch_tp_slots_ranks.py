"""The slot lane over a (data × model) mesh on gloo ranks, against one
process.

Worlds of two and four ranks, spawned over gloo beside the test
(``tests/torch_tp_slots.py``), serve the reduced f32 dense, ssm and hybrid
families with ``SlotServer(mesh=ProcessMesh(...))`` at (data, model) =
(1, 2), (2, 1), (2, 2) and (1, 4), and the MoE at (1, 2) and (1, 4) (at
two data ranks it dispatches a decode step in two groups, as JAX does, so
it is held to JAX on that mesh: ``test_torch_tp_slots_jax.py``).  Every
rank's ``ServeResult`` equals one process's: the greedy tokens, TTFT,
occupancy, the step and chunk counts, the degradation maps and the
lowered schedule.

A resilient dense serve at (2, 2) (two attempts, a poisoned cell, a drain
at step 7, a preemption at step 6 and a resume from the ranked snapshot it
left) has, on every rank, the ledger and tokens of the same serve in one
process; one process refuses to resume the mesh's snapshot.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_slots as TS                                    # noqa: E402

MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
ENTRIES = ([f"{f}@{d}x{m}" for f in ("dense", "ssm", "hybrid")
            for d, m in MESHES] + [f"moe@1x{m}" for m in (2, 4)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_slots_ranks")
    started = TS.start_ranks(tmp, ENTRIES, resilient=True)
    one = {f: TS.port_serve(f, None) for f in TS.FAMILIES}
    one_res = TS.resilient_serve(None, str(tmp / "one_snap"))
    return one, one_res, TS.join_ranks(started)


@pytest.mark.parametrize("entry", ENTRIES)
def test_mesh_slot_serve_equals_one_process(runs, entry):
    one, _, ranks = runs
    fam, d, m = TS.parse(entry)
    got = ranks[entry]
    assert len(got) == d * m
    want = one[fam]
    assert (want["tokens"] >= 0).all()
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["tokens"], want["tokens"],
                                      err_msg=f"rank {r}")
        assert TS.same(res, want), r


def test_resilient_serve_resumes_on_the_mesh_as_one_process(runs):
    from repro_torch.distributed import SlotConfig, SlotServer
    from repro_torch.configs import get_arch

    _, one, ranks = runs
    want = one["resumed"]
    assert want["attempts"] and want["drained"] and want["resumed_from"]
    for r, res in enumerate(ranks["resilient"]):
        assert res["preempted_at"] == one["preempted_at"], r
        np.testing.assert_array_equal(res["resumed"]["tokens"],
                                      want["tokens"], err_msg=f"rank {r}")
        assert TS.same(res["resumed"], want), r
    kw = TS.serve_kw("dense", 512)
    srv = SlotServer(TS.cfg_of("dense", get_arch), SlotConfig(**kw["slots"]),
                     device="cpu")
    with pytest.raises(ValueError, match="mesh mismatch"):
        srv.serve(TS.whole_params("dense"), kw["prompts"], kw["max_new"],
                  admission=kw["admission"], arrivals=kw["arrivals"],
                  resume_from=ranks["resilient"][0]["snapshot"])
