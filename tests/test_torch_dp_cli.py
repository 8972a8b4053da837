"""The train CLI's meshes (``repro_torch.launch.train``).

``--host-mesh`` on one process trains on the host mesh (data 1, model 1),
through a process group of one; under a launcher of two ranks
(``WORLD_SIZE`` 2) it is (data 1, model 2), which trains the dense family
tensor-parallel and refuses an ssm arch with exit 2 naming ROADMAP.md
before any process group starts; ``--multi-pod``, and no mesh flag at all
on several ranks (the production mesh), fail with the world-size message,
as the JAX launcher fails without the devices; ``--mesh`` takes data, pod
and model sizes only; ``--auto-rules`` needs a mesh.  The ranked runs of
the CLI (``--mesh data=2``, and ``--host-mesh`` on two ranks) are driven
on two spawned gloo ranks: each curve equals one process's within the
bf16 trainer tolerance, rtol 5e-3 (the ranks sum bf16 gradient shares,
or bf16 partial sums over the model ranks), rank 0 alone prints, and the
data-parallel checkpoint holds the JAX layout's ``(2, cols)`` pools.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp as D                                           # noqa: E402
from repro_torch.launch import train as launch_train           # noqa: E402

ARGS = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--steps",
        "3", "--n-groups", "2", "--update-impl", "pallas_pooled",
        "--seq-len", "16"]


def test_host_mesh_on_one_rank_trains(capsys):
    import torch.distributed as dist

    res = launch_train.main(ARGS + ["--host-mesh", "--auto-rules"])
    assert res.extra["mesh"] == {"data": 1, "model": 1}
    assert res.extra["ranks"] == 1 and np.isfinite(res.losses).all()
    assert res.extra["collectives"]["reduce_scatter"] == [1.0, res.x[
        "pools"]["bfloat16"]["p"].numel() * 2]
    assert not dist.is_initialized()          # the CLI's group is gone
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out


@pytest.mark.parametrize("flags,words", [
    (["--arch", "mamba2-370m", "--mesh", "data=1,model=4"],
     ["--mesh", "needs 4 processes", "started 2"]),
    (["--multi-pod"], ["--multi-pod", "needs 512 processes",
                       "started 2"]),
    ([], ["the production mesh", "needs 256 processes", "started 2"]),
    (["--mesh", "data=4"], ["--mesh", "needs 4 processes", "started 2"]),
    (["--mesh", "data=1,expert=2"],
     ["--mesh", "want data=N[,pod=P][,model=M]"]),
])
def test_two_ranks_refuse_what_they_cannot_run(flags, words, monkeypatch,
                                               capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit) as e:
        launch_train.main(ARGS + flags)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert all(w in err for w in words), err


def test_auto_rules_needs_a_mesh(capsys):
    with pytest.raises(SystemExit) as e:
        launch_train.main(ARGS + ["--auto-rules"])
    assert e.value.code == 2
    assert "--auto-rules" in capsys.readouterr().err


def _cli_ranks(rank, world, out_dir, flags=("--mesh", "data=2")):
    import contextlib
    import io

    from repro_torch.launch.mesh import ProcessMesh

    ap = launch_train.parser()
    args = ap.parse_args(ARGS + list(flags) + [
        "--ckpt", os.path.join(out_dir, "ckpt")])
    mesh = launch_train.choose_mesh(args, ap, world)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = launch_train._train(args, ap, ProcessMesh(mesh.shape))
    np.save(os.path.join(out_dir, f"losses{rank}.npy"), res.losses)
    with open(os.path.join(out_dir, f"out{rank}.txt"), "w") as f:
        f.write(buf.getvalue())


def test_cli_trains_on_two_ranks(tmp_path):
    started = D.start(_cli_ranks, 2, tmp_path)
    one = launch_train.main(ARGS)             # while the ranks run
    out = D.join(started)
    for r in (0, 1):
        np.testing.assert_allclose(np.load(os.path.join(
            out, f"losses{r}.npy")), one.losses, rtol=5e-3)
    with open(os.path.join(out, "out0.txt")) as f:
        assert "mesh={'data': 2, 'model': 1}" in f.read()
    with open(os.path.join(out, "out1.txt")) as f:
        assert f.read() == ""                 # rank 0 alone prints
    state = np.load(os.path.join(out, "ckpt", "state.npz"))
    p = state["__bf16__['pools']['bfloat16']['p']"]
    assert p.shape[0] == 2
    for k in ("m", "v"):
        assert state[f"['pools']['bfloat16']['{k}']"].shape == p.shape
    assert state["__bf16__['pools']['bfloat16']['gbuf']"].shape == p.shape


def test_host_mesh_on_two_ranks_trains_tensor_parallel(tmp_path):
    """``--host-mesh`` under two ranks: (data 1, model 2), the dense
    family tensor-parallel; its checkpoint holds one process's pools."""
    started = D.start(_cli_ranks, 2, tmp_path, ("--host-mesh",))
    one = launch_train.main(ARGS)
    out = D.join(started)
    for r in (0, 1):
        np.testing.assert_allclose(np.load(os.path.join(
            out, f"losses{r}.npy")), one.losses, rtol=5e-3)
    with open(os.path.join(out, "out0.txt")) as f:
        assert "mesh={'data': 1, 'model': 2}" in f.read()
    with open(os.path.join(out, "out1.txt")) as f:
        assert f.read() == ""
    state = np.load(os.path.join(out, "ckpt", "state.npz"))
    assert state["__bf16__['pools']['bfloat16']['p']"].shape == tuple(
        one.x["pools"]["bfloat16"]["p"].shape)
