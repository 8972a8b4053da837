"""The dry-run tracing one rank of the production meshes, on ``meta``: the
hybrid family (as ``tests/test_torch_tp_dryrun.py``), and the stand-in
collectives against a real world's.

zamba2-7b at model 8: 112 SSM heads as 14 a rank, the shared block's 32
heads as 4, 81 Mamba2 layers (13 groups of six and a three-layer tail),
at ``train_4k`` and ``decode_32k``, each mesh's record OK with the rank's
collectives counted.

The stand-ins (``launch.mesh.TracedMesh``, ``distributed.collectives.
TracedGroup``) count what a real rank's collectives count: one round of
reduced qwen2-0.5b on the per-leaf reference route at (data 1, model 2),
traced with the stand-ins on the CPU, gives the calls and operand bytes
of each kind that ``tests/test_torch_tp_ranks.py`` counts by hand and
holds a gloo world of two to.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                            # noqa: E402
import torch_tp as TT                                           # noqa: E402
from test_torch_tp_ranks import _hand_count                     # noqa: E402

CASES = [("zamba2-7b", s) for s in ("train_4k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", CASES)
def test_a_rank_of_both_production_meshes_traces(arch, shape, tmp_path):
    TT.check_rank_records(TT.dryrun_both_meshes(arch, shape, tmp_path),
                          arch, shape)


def test_stand_in_collectives_count_as_a_real_ranks():
    from repro_torch.distributed import collectives as C
    from repro_torch.launch import op_cost
    from repro_torch.launch.mesh import TracedMesh
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    tr = D.port_trainer("dense_reference", TracedMesh(
        {"data": 1, "model": 2}))
    params = tree_map(lambda p: p.float(), M.init_params(tr.cfg, 0, "cpu"))
    state = tr.init_state(params=params)
    step = tr.train_step_fn()
    batch = {"tokens": torch.from_numpy(D.tokens(tr.cfg.vocab, 8, 16,
                                                 0)).long()}
    mask = torch.from_numpy(D.mask(4, 0))
    state, _ = step(state, batch, mask)
    before = C.snapshot()
    cost = op_cost.analyze(step, state, batch, mask)
    want = _hand_count()
    assert C.since(before) == want
    assert cost.collective_bytes == sum(b for _, b in want.values())
    assert cost.collective_breakdown.get("all-reduce", 0) == \
        want["all_reduce"][1]
    assert np.isfinite(cost.dot_flops)
