"""The train CLI's host mesh on two gloo ranks for the ssm and audio
families: ``--host-mesh`` under a launch of two ranks is (data 1, model
2), tensor-parallel; each rank's curve equals one process's (rtol 5e-3,
the bound of ``tests/test_torch_dp_cli.py``, whose rank function this
file runs), rank 0 alone prints, and the checkpoint holds one process's
pools."""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_dp as D                                            # noqa: E402
from repro_torch.launch import train as launch_train            # noqa: E402
from test_torch_dp_cli import ARGS, _cli_ranks                  # noqa: E402


@pytest.mark.parametrize("arch", ["mamba2-370m", "seamless-m4t-large-v2"])
def test_host_mesh_on_two_ranks_trains_tensor_parallel(arch, tmp_path):
    flags = ("--arch", arch, "--host-mesh")
    started = D.start(_cli_ranks, 2, tmp_path, flags)
    one = launch_train.main(ARGS + ["--arch", arch])
    out = D.join(started)
    for r in (0, 1):
        np.testing.assert_allclose(np.load(os.path.join(
            out, f"losses{r}.npy")), one.losses, rtol=5e-3)
    with open(os.path.join(out, "out0.txt")) as f:
        text = f.read()
    assert "mesh={'data': 1, 'model': 2}" in text and f"arch={arch}" in text
    with open(os.path.join(out, "out1.txt")) as f:
        assert f.read() == ""
    state = np.load(os.path.join(out, "ckpt", "state.npz"))
    assert state["__bf16__['pools']['bfloat16']['p']"].shape == tuple(
        one.x["pools"]["bfloat16"]["p"].shape)
