"""The dry-run tracing one rank of the production meshes, on ``meta``:
the dense, MoE and audio families (the others: ``tests/
test_torch_tp_dryrun_ssm.py`` and ``tests/test_torch_tp_dryrun_hybrid.py``,
split so that no file runs long).

``python -m repro_torch.launch.dryrun --arch A --shape S --both-meshes``
for qwen2-0.5b, deepseek-moe-16b and seamless-m4t-large-v2 at ``train_4k``
and ``decode_32k``: one record per production mesh, ``32x8`` (256 cards)
and ``2x32x8`` (512), each traced OK, with the JAX record keys, the
rank's collectives counted (nonzero: every arch splits at model 8) and
an analytic state per card below one card's.  The full-width trace of
rank 0 is the step a rank of those meshes runs: its blocks at model 8
(qwen2-0.5b's 14 heads gathered, its ring split on ``ctx``; seamless's
256206 words not divisible by 8, its unembedding gathered), the data
axes' share of the batch, no process group (``launch.mesh.TracedMesh``).
A one-card record keeps its keys (``h100x1``, one device, no
collectives).
"""
import pytest

pytest.importorskip("torch")

import torch_tp as TT                                           # noqa: E402

CASES = [(a, s) for a in ("qwen2-0.5b", "deepseek-moe-16b",
                          "seamless-m4t-large-v2")
         for s in ("train_4k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", CASES)
def test_a_rank_of_both_production_meshes_traces(arch, shape, tmp_path):
    TT.check_rank_records(TT.dryrun_both_meshes(arch, shape, tmp_path),
                          arch, shape)


def test_a_one_card_record_keeps_its_keys():
    from repro_torch.launch import dryrun

    rec = dryrun.run_one("qwen2-0.5b", "decode_32k", verbose=False)
    assert rec["ok"] and (rec["mesh"], rec["n_devices"]) == ("h100x1", 1)
    assert rec["op_cost"]["collective_bytes"] == 0
