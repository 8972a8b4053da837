"""The dry-run tracing one rank of the production meshes, on ``meta``: the
ssm and vlm families (as ``tests/test_torch_tp_dryrun.py``).

mamba2-370m at model 8: its 32 SSM heads as 4 a rank (the SSD kernel's
last head group smaller than its four), its 2304 conv columns as 288 a
rank against 256 x columns; pixtral-12b: 32 query heads on 8 kv heads as
4 on 1 a rank.  Both at ``train_4k`` and ``decode_32k``, each mesh's
record OK with the rank's collectives counted.
"""
import pytest

pytest.importorskip("torch")

import torch_tp as TT                                           # noqa: E402

CASES = [(a, s) for a in ("mamba2-370m", "pixtral-12b")
         for s in ("train_4k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", CASES)
def test_a_rank_of_both_production_meshes_traces(arch, shape, tmp_path):
    TT.check_rank_records(TT.dryrun_both_meshes(arch, shape, tmp_path),
                          arch, shape)
