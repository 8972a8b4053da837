"""The port's CUDA kernel on the card, held to its plain version.

Every test here is marked ``cuda`` and skips on a host without a card: the
kernel is CUDA C++ for ``sm_90a`` and has no CPU mode (the CPU tests hold
the plain version to the Pallas kernel instead).  The file imports neither
JAX nor the JAX package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of the kernel suite, ``test_kernels.py``: f32 2e-4,
bf16 3e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch                   # noqa: E402
from repro_torch.kernels import flash_attention as FA      # noqa: E402
from repro_torch.kernels import ops                        # noqa: E402
from repro_torch.models import init_params, prefill        # noqa: E402

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, B, Sq, Sk, H, KV, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(device=device, dtype=dtype)
                 for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window", [
    (4, 1024, 1024, 14, 2, 64, True, None),   # the serving path's prefill
    (1, 128, 128, 4, 4, 64, True, None),      # MHA square
    (2, 256, 256, 8, 2, 64, True, None),      # GQA 4:1
    (1, 96, 160, 4, 1, 32, True, None),       # ragged MQA
    (1, 512, 512, 2, 2, 128, True, None),     # D = 128
    (1, 256, 256, 4, 4, 64, True, 16),        # windows
    (1, 256, 256, 4, 4, 64, True, 64),
    (1, 256, 256, 4, 4, 64, True, 1000),
    (2, 128, 192, 4, 4, 64, False, None),     # non-causal
    (1, 128, 32, 2, 2, 32, False, 16),        # rows that see no key → 0
])
def test_flash_kernel_matches_plain(cuda_device, dtype, B, Sq, Sk, H, KV, D,
                                    causal, window):
    q, k, v = _qkv(cuda_device, B, Sq, Sk, H, KV, D, dtype)
    before = FA.launches
    got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, FA.flash_attention_plain(q, k, v, causal=causal,
                                         window=window), dtype)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    """q/k/v as non-contiguous BSHD views of BHSD storage."""
    q, k, v = _qkv(cuda_device, 2, 80, 80, 4, 2, 64, torch.float32)
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    assert not qt.is_contiguous()
    got = FA.flash_attention_cuda(qt, kt, vt, causal=True, window=24)
    _close(got, FA.flash_attention_plain(q, k, v, causal=True, window=24),
           torch.float32)


@pytest.mark.cuda
def test_ops_route_cuda_tensors_to_kernel_or_raise(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 64, 64, 2, 2, 64, torch.bfloat16)
    before = FA.launches
    ops.flash_attention(q, k, v, causal=True)
    assert FA.launches == before + 1
    q48, k48, v48 = _qkv(cuda_device, 1, 64, 64, 2, 2, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q48, k48, v48)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())
    assert FA.launches == before + 1


@pytest.mark.cuda
def test_prefill_launches_once_per_layer_and_matches_plain(cuda_device):
    cfg = get_arch("qwen2-0.5b").reduced()
    params = init_params(cfg, 0, cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 96))).to(cuda_device)
    before = FA.launches
    got, cache = prefill(cfg.with_(use_flash_attention=True), params,
                         {"tokens": tokens}, ctx_len=100)
    assert FA.launches == before + cfg.n_layers
    want, want_cache = prefill(cfg, params, {"tokens": tokens}, ctx_len=100)
    _close(got, want, torch.bfloat16)
    torch.testing.assert_close(cache["positions"], want_cache["positions"])
