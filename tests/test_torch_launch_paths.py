"""The port's launch tier writes its own files, and its refusals name live
roadmap items.

The port's dry-run, roofline and hill-climb default to
``experiments/dryrun_torch/`` and ``experiments/hillclimb_torch_{pair}
.json``: the JAX dry-run's directory ``experiments/dryrun/`` (whose
records the JAX ``tests/test_launch.py`` reads) and the JAX hill-climb's
``experiments/hillclimb_{pair}.json`` stay the JAX package's.  Each
``main`` runs with its default paths in a temporary working directory: the
dry-run on one arch × shape on ``meta``, the roofline over its record, the
hill-climb on a pair cut to the reduced config and a small prefill.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import InputShape, get_arch           # noqa: E402
from repro_torch.launch import dryrun, hillclimb, roofline     # noqa: E402


def test_dryrun_and_roofline_default_to_the_port_directory(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k"])
    assert not os.path.exists("experiments/dryrun")
    recs = os.listdir("experiments/dryrun_torch")
    assert recs == ["mamba2-370m_decode_32k_h100x1.json"]
    with open(os.path.join("experiments/dryrun_torch", recs[0])) as f:
        assert json.load(f)["ok"]
    roofline.main([])
    assert "| mamba2-370m | decode_32k |" in capsys.readouterr().out


def test_hillclimb_writes_the_port_file_name(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(hillclimb.PAIRS, "qwen2_prefill", (
        get_arch("qwen2-0.5b").reduced(),
        InputShape("hc_prefill", 64, 32, "prefill")))
    hillclimb.main(["--pair", "qwen2_prefill"])
    assert os.listdir("experiments") == ["hillclimb_torch_qwen2_prefill.json"]
    assert not os.path.exists("experiments/hillclimb_qwen2_prefill.json")
    with open("experiments/hillclimb_torch_qwen2_prefill.json") as f:
        assert json.load(f)["baseline"]["ok"]


def test_flash_backward_refusal_names_the_step_item():
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    k = v = torch.zeros(1, 4, 2, 16)
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md queue 2, step item 2"):
        flash_attention_cuda(q, k, v)
