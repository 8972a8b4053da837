"""The port's CUDA kernels on the card, held to their plain versions.

Every test here is marked ``cuda`` and skips on a host without a card: the
kernels are CUDA C++ for ``sm_90a`` and have no CPU mode (the CPU tests hold
the plain versions to the Pallas kernels instead).  The file imports neither
JAX nor the JAX package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of the kernel suite, ``test_kernels.py``: flash and
the SGD and heavy-ball updates f32 2e-4, the Adam updates f32 rtol 1e-5 /
atol 1e-6, bf16 3e-2; the update kernels' buffer swap is bitwise, and at
run flag 0 they write nothing (every output keeps its bits); the SSD
kernel f32 1e-3, bf16 4e-2, and a prefill through it within bf16 3e-2 of
the einsum branch (``test_kernels.py:169-267``).

The slot server's tests hold its captured decode chunk to the same steps
run eagerly (tokens bit for bit), each request of a rotation through
every slot to the same request served alone, and a serve resumed from a
snapshot into a fresh capture to the uninterrupted serve; the snapshotter's
test holds an offered state against the in-place updates queued after it.

The hybrid and MoE families (zamba2-7b, deepseek-moe-16b) add flash at
their prefill shapes (D = 112 and 128), SSD at zamba2-7b's (112 heads,
N 64), and a full-width, reduced-depth slot serve of each whose captured
chunk equals the eager steps bit for bit.  The audio and vlm families
(seamless-m4t-large-v2, pixtral-12b) add flash non-causal at Sq = Sk and
Sq ≠ Sk with GQA 4 (D 64 and 128), on einsum-made cross k/v, and a
reduced forward and prefill of each with the kernel against without.

The pooled update's tests run ``optim.pool`` over qwen2-0.5b's 14-leaf
bf16 pool at 2 layers: one launch per call against the same call routed
to the plain versions on the card (the update tolerances above), and at
run flag 0 on NaN grads every pool and the count keep their bits; a
pooled run launches once per round, within 5e-3 of the per-leaf curve,
and its ``metrics="tap"`` rows equal the chunk transport's bit for bit.

The launch tier's tests trace one reduced step on ``meta`` and tally the
same step on the card under ``launch/op_cost.py``: a pooled training
round and a hybrid prefill with flash and SSD on must count equal dot
flops and bytes, each kernel once per launch.

The theory tier has no kernel of its own: its replay runs torch ops as
CUDA graph chunks.  Its card tests hold the graph route to the eager loop
and a grid to solo replays bit for bit, and the card to the CPU within
``chip_smoke.py``'s rtol 1e-4 / atol 1e-6.
"""
import ctypes
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (ExperimentSpec, SimulatorBackend,  # noqa: E402
                             TrainerBackend, TrainJob, run)
from repro_torch.configs import (InputShape, get_arch,     # noqa: E402
                                 smoke_shape)
from repro_torch.core import replay, replay_grid           # noqa: E402
from repro_torch.distributed import SlotConfig, SlotServer  # noqa: E402
from repro_torch.kernels import async_update as AU         # noqa: E402
from repro_torch.kernels import flash_attention as FA      # noqa: E402
from repro_torch.kernels import ops                        # noqa: E402
from repro_torch.kernels import ssd_chunk as SSD           # noqa: E402
from repro_torch.launch import dryrun, op_cost             # noqa: E402
from repro_torch.models import init_params, prefill        # noqa: E402
from repro_torch.objectives import (LogRegProblem,         # noqa: E402
                                    make_synthetic)
from repro_torch.tree import tree_map                      # noqa: E402

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
    (1, 1000, 1000, 2, 2, 64, True, None),    # Sq not a multiple of 64
    (2, 192, 192, 7, 1, 64, True, None),      # H/KV = 7
    (1, 512, 512, 4, 4, 64, True, 100),       # a window off the 64-key tile
    (2, 200, 300, 4, 2, 64, False, None),     # non-causal, ragged Sk > Sq
    (1, 256, 32, 2, 2, 64, False, 16),        # q tiles that visit no key tile
    (1, 512, 64, 2, 2, 64, True, 100),
    (1, 512, 512, 14, 2, 64, True, None),     # the slot lane's admission
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,window,ranks", [
    (4, 256, 1024, 14, 2, 64, None, 4),     # qwen2-0.5b at model 4
    (1, 200, 800, 4, 2, 64, 100, 4),        # a window, rows off the tile
    (2, 96, 192, 4, 4, 32, None, 2),
])
def test_flash_kernel_at_q_offset_matches_plain_and_the_whole(
        cuda_device, dtype, B, Sq, Sk, H, KV, D, window, ranks):
    """Sequence parallelism's call: each rank's block of query rows at its
    offset against the whole sequence's k / v, causal, held to its plain
    version and to the same rows of a whole-sequence launch."""
    q, k, v = _qkv(cuda_device, B, Sk, Sk, H, KV, D, dtype)
    whole = FA.flash_attention_cuda(q, k, v, causal=True, window=window)
    n = Sk // ranks
    for r in range(ranks):
        rows = q[:, r * n:r * n + min(n, Sq)]
        before = FA.launches
        got = FA.flash_attention_cuda(rows, k, v, causal=True, window=window,
                                      q_offset=r * n)
        assert FA.launches == before + 1
        _close(got, FA.flash_attention_plain(rows, k, v, causal=True,
                                             window=window, q_offset=r * n),
               dtype)
        _close(got, whole[:, r * n:r * n + rows.shape[1]], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,q_offset", [
    (1, 192, 192, 4, 2, 64, True, None, 0),     # S a multiple of 64, not 128
    (1, 320, 320, 4, 2, 64, True, None, 0),
    (2, 320, 192, 4, 2, 64, False, None, 0),
    (1, 64, 1, 4, 2, 64, False, None, 0),       # ragged Sk below one tile
    (1, 100, 33, 4, 2, 64, False, None, 0),
    (1, 33, 33, 4, 1, 64, True, None, 0),
    (4, 640, 640, 7, 1, 64, True, None, 0),     # H/KV 7 on 128-row tiles
    (4, 1024, 1024, 8, 2, 64, True, 300, 0),    # windows ending in a tile
    (2, 700, 700, 8, 2, 64, True, 200, 0),
    (2, 200, 400, 4, 2, 64, True, None, 77),    # q_offsets off the tiles
    (4, 384, 1024, 14, 2, 64, True, None, 333),
    (4, 384, 1024, 14, 2, 112, True, 150, 333),
    (4, 1024, 64, 14, 2, 64, False, 16, 0),     # q tiles that see no key
    (1, 1, 40, 4, 2, 64, False, None, 0),       # one query row
    (4, 300, 300, 32, 8, 80, False, None, 0),   # D 80 on 128-row tiles
])
def test_flash_kernel_at_the_tiles_edges(cuda_device, dtype, B, Sq, Sk, H,
                                         KV, D, causal, window, q_offset):
    """The edges of the bf16 route's tiles: 128 query rows (64 where
    128-row tiles would be fewer than the SMs), 128 keys, 64-column
    shared-memory panels, rows and columns past the tensor zero-filled by
    the TMA; every output finite."""
    q, k, v = _qkv(cuda_device, B, Sq, Sk, H, KV, D, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = FA.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, FA.flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_a_size1_batch_view(cuda_device, dtype):
    """q / k / v as views of batch row 1 of a fused (2, S, H + 2 KV, D)
    projection: the wrapper passes stride 0 for the size-1 batch, which a
    TMA tensor map cannot take, and the views are read in place."""
    g = torch.Generator(cuda_device).manual_seed(1)
    qkv = torch.randn((2, 300, 18, 64), generator=g,
                      device=cuda_device).to(dtype)
    q, k, v = qkv[1:2, :, :14], qkv[1:2, :, 14:16], qkv[1:2, :, 16:]
    got = FA.flash_attention_cuda(q, k, v, causal=True, window=100)
    _close(got, FA.flash_attention_plain(q, k, v, causal=True, window=100),
           dtype)
    # the bf16 route's host work: three tensor-map encodes, no device work
    q16, k16, v16 = (t.bfloat16() for t in (q, k, v))
    assert 0 < FA.encode_us(q16, k16, v16, iters=100) < 1000


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 48, 80, 96, 112])
def test_flash_kernel_every_head_dim(cuda_device, dtype, D):
    """The head dims beyond 32/64/128, zamba2-7b's 112 among them (7 k16
    steps on the tensor-core route), causal, windowed and not, with a q
    tile that ends inside the sequence."""
    q, k, v = _qkv(cuda_device, 2, 200, 200, 4, 2, D, dtype)
    for causal, window in ((True, None), (True, 64), (False, None)):
        got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
        _close(got, FA.flash_attention_plain(q, k, v, causal=causal,
                                             window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,D", [(32, 112), (16, 128)],
                         ids=["zamba2-7b", "deepseek-moe-16b"])
def test_flash_kernel_at_the_new_families_prefill(cuda_device, dtype, H, D):
    """The prefill of 4 prompts of 1024 tokens on zamba2-7b's shared
    attention (32 heads of 112) and deepseek-moe-16b's (16 of 128)."""
    q, k, v = _qkv(cuda_device, 4, 1024, 1024, H, H, D, dtype)
    got = FA.flash_attention_cuda(q, k, v, causal=True)
    _close(got, FA.flash_attention_plain(q, k, v, causal=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk", [(1024, 1024), (256, 1024), (1000, 1024)])
@pytest.mark.parametrize("H,KV,D", [(16, 4, 64), (32, 8, 128)])
def test_flash_kernel_non_causal_at_the_new_families_shapes(
        cuda_device, dtype, Sq, Sk, H, KV, D):
    """Non-causal attention, GQA 4: Sq = Sk as in the audio encoder, Sq <
    Sk as in its cross-attention (256 decoder positions against 1024
    frames), and a Sq off the 64-row tile."""
    q, k, v = _qkv(cuda_device, 2, Sq, Sk, H, KV, D, dtype)
    got = FA.flash_attention_cuda(q, k, v, causal=False)
    _close(got, FA.flash_attention_plain(q, k, v, causal=False), dtype)


@pytest.mark.cuda
def test_flash_kernel_reads_cross_memory_projections(cuda_device):
    """The cross-attention's k/v as the model makes them, ``memory @ wk``
    through an einsum (whatever its strides), in bf16."""
    mem = torch.randn(2, 1024, 256, device=cuda_device, dtype=torch.bfloat16)
    wk, wv = (torch.randn(256, 4, 64, device=cuda_device,
                          dtype=torch.bfloat16) / 16 for _ in range(2))
    k = torch.einsum("bsd,dhk->bshk", mem, wk)
    v = torch.einsum("bsd,dhk->bshk", mem, wv)
    q = torch.randn(2, 256, 16, 64, device=cuda_device, dtype=torch.bfloat16)
    got = FA.flash_attention_cuda(q, k, v, causal=False)
    _close(got, FA.flash_attention_plain(q, k, v, causal=False),
           torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "pixtral-12b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_vlm_forward_flash_on_matches_off(cuda_device, arch, dtype):
    """A reduced forward and prefill with the flash kernel against the
    plain attention: one launch per attention (audio: encoder, decoder
    self and cross), logits within the kernel tolerance."""
    from repro_torch.models import batch_specs, forward_logits
    cfg = get_arch(arch).reduced().with_(dtype=dtype)
    params = init_params(cfg, 0, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, sp.shape, generator=gen,
                              device=cuda_device) if sp.dtype == "int32"
             else torch.randn(sp.shape, generator=gen, device=cuda_device)
             for k, sp in batch_specs(cfg, 2, 128).items()}
    on = cfg.with_(use_flash_attention=True)
    per_pass = (cfg.enc_layers + 2 * cfg.n_layers if cfg.family == "audio"
                else cfg.n_layers)
    with torch.no_grad():
        before = FA.launches
        got = forward_logits(on, params, batch)[0]
        last = prefill(on, params, batch)[0]
        assert FA.launches == before + 2 * per_pass
        _close(got, forward_logits(cfg, params, batch)[0],
               getattr(torch, dtype))
        _close(last, prefill(cfg, params, batch)[0], getattr(torch, dtype))


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
def test_flash_kernel_copies_unaligned_bf16_views(cuda_device):
    """The tensor-core route stages 16-byte rows: a bf16 view whose rows
    are not 16-byte aligned (here an odd column offset into wider rows) is
    copied first and gives the plain version's result."""
    q, k, v = _qkv(cuda_device, 1, 96, 96, 3, 1, 70, torch.bfloat16)
    qs, ks, vs = (t[..., 3:67] for t in (q, k, v))
    assert qs.data_ptr() % 16 and qs.stride(1) % 8
    got = FA.flash_attention_cuda(qs, ks, vs, causal=True)
    _close(got, FA.flash_attention_plain(qs, ks, vs, causal=True),
           torch.bfloat16)


@pytest.mark.cuda
def test_ops_route_cuda_tensors_to_kernel_or_raise(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 64, 64, 2, 2, 64, torch.bfloat16)
    before = FA.launches
    ops.flash_attention(q, k, v, causal=True)
    assert FA.launches == before + 1
    # a head dim off the multiples of 16 is refused (48 is built since D
    # became any multiple of 16 up to 128)
    q40, k40, v40 = _qkv(cuda_device, 1, 64, 64, 2, 2, 40, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q40, k40, v40)
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


@pytest.mark.cuda
def test_flash_cuda_route_raises_under_grad(cuda_device):
    """The kernel has no backward: an input that requires grad raises
    instead of losing its gradient; under no_grad it launches."""
    q, k, v = _qkv(cuda_device, 1, 64, 64, 2, 2, 64, torch.bfloat16)
    q.requires_grad_(True)
    before = FA.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.flash_attention(q, k, v)
    assert FA.launches == before
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    assert FA.launches == before + 1


def _update_operands(device, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a, dt: torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                                 dtype=dt)
    return {"p": t(rng.standard_normal(n), dtype),
            "m": t(rng.standard_normal(n) * 0.1, torch.float32),
            "v": t(rng.uniform(size=n) * 0.01, torch.float32),
            "gb": t(rng.standard_normal(n), dtype),
            "g": t(rng.standard_normal(n), dtype)}


def _operands(name, t):
    return {"async_update": ("p", "gb", "g"), "sgd_step": ("p", "g"),
            "sgd_momentum_step": ("p", "m", "g"),
            "sgd_momentum_delayed": ("p", "m", "gb", "g"),
            "fused_adam": ("p", "m", "v", "g"),
            "fused_adam_delayed": ("p", "m", "v", "gb", "g")}[name]


def _scalars(name, device):
    if "adam" in name:
        c = torch.tensor(5, dtype=torch.int32, device=device)
        bc1, bc2 = AU.adam_bias_corrections(0.9, 0.95, c)
        return AU.adam_scalars(1e-3, bc1, bc2, 0.5, 0.01, device)
    if "momentum" in name:
        return AU.momentum_scalars(0.02, 0.5, 0.25, device)
    return AU.sgd_scalars(0.02, 0.5, 0.25, device)


def _kw(name):
    return {"momentum": 0.9} if "momentum" in name else {}


def _compared(name):
    """The float state each kernel writes besides the buffer."""
    if "adam" in name:
        return ("p", "m", "v")
    return ("p", "m") if "momentum" in name else ("p",)


@pytest.mark.cuda
@pytest.mark.parametrize("name", AU.KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 127, 128 * 256 + 37, 1_000_003])
def test_update_kernel_matches_plain_in_place(cuda_device, name, dtype, n):
    base = _update_operands(cuda_device, n, dtype)
    scal = _scalars(name, cuda_device)
    keys = _operands(name, base)
    got = {k: v.clone() for k, v in base.items()}
    want = {k: v.clone() for k, v in base.items()}
    ptrs = {k: got[k].data_ptr() for k in keys}
    before = AU.launches[name]
    out = getattr(AU, f"{name}_cuda")(*(got[k] for k in keys), scal,
                                      **_kw(name))
    torch.cuda.synchronize()
    assert AU.launches[name] == before + 1
    getattr(AU, f"{name}_plain")(*(want[k] for k in keys), scal, **_kw(name))
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.data_ptr() in ptrs.values() for o in outs)   # in place
    tol = ({torch.float32: dict(rtol=1e-5, atol=1e-6)} if "adam" in name
           else {torch.float32: dict(rtol=2e-4, atol=2e-4)})
    tol[torch.bfloat16] = dict(rtol=3e-2, atol=3e-2)
    for k in _compared(name):
        np.testing.assert_allclose(got[k].float().cpu().numpy(),
                                   want[k].float().cpu().numpy(), **tol[dtype])
    assert got["p"].dtype == dtype
    if "gb" in keys:
        assert torch.equal(got["gb"], base["g"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", AU.KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [127, 128 * 256 + 37, 1_000_003])
def test_update_kernel_run_flag_zero_writes_nothing(cuda_device, name, dtype,
                                                    n):
    """Run flag 0 (the guard rails' skip) on NaN g: the launch is counted
    and every output keeps its input's bits, the stale buffer included."""
    base = _update_operands(cuda_device, n, dtype)
    base["g"][::3] = float("nan")
    scal = _scalars(name, cuda_device).clone()
    scal[-1] = 0.0
    keys = _operands(name, base)
    got = {k: v.clone() for k, v in base.items()}
    before = AU.launches[name]
    getattr(AU, f"{name}_cuda")(*(got[k] for k in keys), scal, **_kw(name))
    torch.cuda.synchronize()
    assert AU.launches[name] == before + 1
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 \
        else t.view(torch.int32)
    for k in keys:
        assert torch.equal(bits(got[k]), bits(base[k])), k


@pytest.mark.cuda
def test_update_kernels_refuse_what_they_do_not_take(cuda_device):
    t = _update_operands(cuda_device, 64, torch.bfloat16)
    scal = _scalars("fused_adam", cuda_device)
    before = dict(AU.launches)
    with pytest.raises(TypeError, match="moments"):
        AU.fused_adam_cuda(t["p"], t["m"].bfloat16(), t["v"], t["g"], scal)
    with pytest.raises(ValueError, match="size"):
        AU.fused_adam_cuda(t["p"], t["m"][:10], t["v"], t["g"], scal)
    with pytest.raises(ValueError, match="contiguous"):
        AU.sgd_step_cuda(t["p"].view(8, 8).t(), t["g"].view(8, 8),
                         _scalars("sgd_step", cuda_device))
    with pytest.raises(ValueError, match="one CUDA device"):
        AU.sgd_step_cuda(t["p"], t["g"].cpu(), _scalars("sgd_step",
                                                        cuda_device))
    with pytest.raises(TypeError, match="scalars"):
        AU.fused_adam_cuda(t["p"], t["m"], t["v"], t["g"], scal[:1])
    assert AU.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("opt,delay,name", [
    ("adam", 1, "fused_adam_delayed"), ("adam", 0, "fused_adam"),
    ("sgd", 1, "async_update"), ("sgd", 0, "sgd_step")])
def test_train_run_launches_its_update_kernel(cuda_device, opt, delay, name):
    """run(TrainJob) at reduced size: rounds × leaves launches of the one
    kernel its (opt, delay_rounds) reaches, and finite curves."""
    T = 3
    spec = ExperimentSpec(
        objective=TrainJob(global_batch=4, seq_len=32, opt=opt,
                           delay_rounds=delay, update_impl="pallas"),
        n_workers=2, T=T, stepsize=1e-3, rounds_per_launch=2)
    AU.reset_launches()
    res = run(spec, device="cuda")
    n_leaves = 14
    want = dict.fromkeys(AU.KERNELS, 0)
    want[name] = T * n_leaves
    assert AU.launches == want
    assert res.extra["update_launches"] == want
    assert np.isfinite(res.losses).all() and np.isfinite(res.grad_norms).all()


@pytest.mark.cuda
@pytest.mark.parametrize("delay", [1, 0])
def test_momentum_trainer_launches_its_kernel(cuda_device, delay):
    """AsyncTrainer with heavy-ball SGD (TrainJob has no momentum field)
    driven by the plan executor: rounds × leaves launches of the kernel its
    delay reaches, and a loss curve within 5e-3 of the reference update."""
    from repro_torch.distributed import AsyncConfig, AsyncTrainer
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import compile_plan, execute

    T, groups = 3, 2
    job = TrainJob(global_batch=4, seq_len=32, delay_rounds=delay)
    spec = ExperimentSpec(objective=job, n_workers=groups, T=T)
    cfg = job.make_arch()
    _, schedule = TrainerBackend.masks_for(spec, groups)
    plan = compile_plan(schedule, job, rounds=T, n_groups=groups)
    base = init_params(cfg, 0, cuda_device)
    curves, launched = {}, {}
    for impl in ("pallas", "reference"):
        tr = AsyncTrainer(cfg, opt=OptConfig(name="sgd", lr=1e-2,
                                             momentum=0.9, update_impl=impl),
                          async_cfg=AsyncConfig(delay_rounds=delay),
                          device=cuda_device)
        tr.n_groups = groups
        state = tr.init_state(params=tree_map(torch.clone, base))
        AU.reset_launches()
        res = execute(tr, plan, state, runtime="scan", rounds_per_launch=2)
        curves[impl], launched[impl] = res.metrics["loss"], dict(AU.launches)
    name = "sgd_momentum_delayed" if delay else "sgd_momentum_step"
    want = dict.fromkeys(AU.KERNELS, 0)
    want[name] = T * 14
    assert launched["pallas"] == want
    assert launched["reference"] == dict.fromkeys(AU.KERNELS, 0)
    assert np.isfinite(curves["pallas"]).all()
    np.testing.assert_allclose(curves["pallas"], curves["reference"],
                               rtol=5e-3)


def _qwen2_pool(device, seed=0):
    """The 14-leaf pool of qwen2-0.5b at 2 layers: (layout, pooled state
    with random p/m/v/gbuf, a random grad pool), bf16 p / gbuf / g, f32
    m / v."""
    from repro_torch.models import param_specs
    from repro_torch.optim import build_layout

    lay = build_layout(param_specs(get_arch("qwen2-0.5b").with_(
        n_layers=2)), 1)
    assert lay.n_leaves == 14 and list(lay.cols) == ["bfloat16"]
    gen = torch.Generator(device).manual_seed(seed)
    shape = (1, lay.cols["bfloat16"])
    randn = lambda: torch.randn(shape, generator=gen, device=device)
    pools = {"bfloat16": {"p": randn().bfloat16(), "m": randn() * 0.1,
                          "v": torch.rand(shape, generator=gen,
                                          device=device) * 0.01,
                          "gbuf": randn().bfloat16()}}
    return lay, pools, {"bfloat16": randn().bfloat16()}


def _pooled_call(name, momentum, delayed, grads, pools, count, run=None):
    from repro_torch.optim import (OptConfig, pooled_delayed_apply,
                                   pooled_update)

    cfg = OptConfig(name=name, lr=1e-3, momentum=momentum, clip_norm=1.0,
                    weight_decay=0.01 if name == "adam" else 0.0)
    apply = pooled_delayed_apply if delayed else pooled_update
    return apply(grads, pools, count, cfg, lr_scale=0.5, run=run)


_POOLED = [("fused_adam_delayed", "adam", 0.0, True),
           ("fused_adam", "adam", 0.0, False),
           ("async_update", "sgd", 0.0, True), ("sgd_step", "sgd", 0.0, False),
           ("sgd_momentum_delayed", "sgd", 0.9, True),
           ("sgd_momentum_step", "sgd", 0.9, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,name,momentum,delayed", _POOLED)
def test_pooled_kernels_match_plain_over_the_qwen2_pool(
        cuda_device, monkeypatch, kernel, name, momentum, delayed):
    """optim.pool's updates over qwen2-0.5b's 14-leaf bf16 pool (2 layers,
    151.7M elements): one launch of the kernel per call, against the same
    call routed to the plain versions on the card."""
    _, pools, grads = _qwen2_pool(cuda_device)
    want = {dk: {k: v.clone() for k, v in b.items()} for dk, b in
            pools.items()}
    count = torch.full((), 4, dtype=torch.int32, device=cuda_device)
    count2 = count.clone()
    AU.reset_launches()
    _, got_count, gnorm = _pooled_call(name, momentum, delayed, grads,
                                       pools, count)
    torch.cuda.synchronize()
    launched = dict(AU.launches)
    with monkeypatch.context() as mp:
        mp.setattr(ops, "_route", lambda what, t: "plain")  # plain, on card
        _, want_count, want_gnorm = _pooled_call(name, momentum, delayed,
                                                 grads, want, count2)
    assert launched == {**dict.fromkeys(AU.KERNELS, 0), kernel: 1}
    assert int(got_count) == int(want_count) == 5
    assert torch.equal(gnorm, want_gnorm)
    tol = dict(rtol=3e-2, atol=3e-2)
    for k in _compared(kernel):
        np.testing.assert_allclose(
            pools["bfloat16"][k].float().cpu().numpy(),
            want["bfloat16"][k].float().cpu().numpy(), err_msg=k, **tol)
    if delayed:
        assert torch.equal(pools["bfloat16"]["gbuf"], grads["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,name,momentum,delayed", _POOLED)
def test_pooled_run_flag_zero_keeps_every_pool(cuda_device, kernel, name,
                                               momentum, delayed):
    """The guard rails' skip through the pools on the card: NaN grads at
    run flag 0, one launch, and every pool and the count keep their bits."""
    _, pools, grads = _qwen2_pool(cuda_device, seed=1)
    grads["bfloat16"][:, ::3] = float("nan")
    kept = {k: v.clone() for k, v in pools["bfloat16"].items()}
    count = torch.full((), 4, dtype=torch.int32, device=cuda_device)
    before = AU.launches[kernel]
    _pooled_call(name, momentum, delayed, grads, pools, count,
                 run=torch.zeros((), device=cuda_device))
    torch.cuda.synchronize()
    assert AU.launches[kernel] == before + 1 and int(count) == 4
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 \
        else t.view(torch.int32)
    for k, v in kept.items():
        assert torch.equal(bits(pools["bfloat16"][k]), bits(v)), k


@pytest.mark.cuda
def test_pooled_and_tap_runs_on_the_card(cuda_device):
    """run(TrainJob(update_impl="pallas_pooled")) at reduced size: one
    fused_adam_delayed launch per round (one bf16 pool), the per-leaf
    route's curve within 5e-3; and metrics="tap" rows bit-equal to the
    chunk transport's, with no host sync."""
    T = 4
    spec = ExperimentSpec(objective=TrainJob(global_batch=4, seq_len=32,
                                             update_impl="pallas_pooled"),
                          n_workers=2, T=T, stepsize=1e-3,
                          rounds_per_launch=2)
    AU.reset_launches()
    pooled = run(spec, device="cuda")
    assert AU.launches == {**dict.fromkeys(AU.KERNELS, 0),
                           "fused_adam_delayed": T}
    leaf = run(dataclasses.replace(spec, objective=TrainJob(
        global_batch=4, seq_len=32, update_impl="pallas")), device="cuda")
    np.testing.assert_allclose(pooled.losses, leaf.losses, rtol=5e-3)
    tap = TrainerBackend("cuda", metrics="tap").run(spec)
    np.testing.assert_array_equal(tap.losses, pooled.losses)
    np.testing.assert_array_equal(tap.grad_norms, pooled.grad_norms)
    assert (tap.extra["host_syncs"], tap.extra["tap_events"],
            tap.extra["launches"]) == (0, T, 2)


#: (B, nc, c, H, P, N): the kernel test matrix of test_kernels.py, ragged
#: sizes (no multiple of 4 or of 32; in bf16 the mma.sync design's: P 20
#: and N 10 are no multiple of 8), the serving path's prefill shape, and
#: the edges of the tensor-core route's tiling: one cell, H not a multiple
#: of 4, c = 32 and c = 128 with N = 64; then the reduced configs' chunk,
#: the model-2 and model-4 ranks' prefill shapes and the batch-1
#: admissions' (split tiles), whose bf16 calls take the Hopper design
SSD_CASES = [(1, 1, 16, 2, 32, 16), (1, 1, 64, 4, 64, 32),
             (2, 3, 13, 3, 20, 10), (4, 8, 128, 32, 64, 128),
             (1, 1, 128, 8, 64, 128), (1, 2, 64, 6, 64, 64),
             (2, 2, 32, 8, 64, 64), (2, 2, 128, 8, 64, 64),
             (1, 2, 16, 4, 64, 128),
             (1, 4, 128, 32, 64, 128),          # the slot lane's admission
             (4, 8, 128, 112, 64, 64),          # zamba2-7b's prefill
             (2, 4, 16, 16, 32, 32),            # the reduced configs' chunk
             (4, 8, 128, 16, 64, 128),          # mamba2-370m at model 2
             (4, 8, 128, 8, 64, 128),           # ... at model 4
             (4, 8, 128, 56, 64, 64),           # zamba2-7b at model 2
             (1, 4, 128, 16, 64, 128),          # admissions on a rank
             (1, 4, 128, 8, 64, 128),
             (1, 4, 128, 56, 64, 64)]
SSD_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-3),
           torch.bfloat16: dict(rtol=4e-2, atol=4e-2)}


def _ssd_inputs(device, B, nc, c, H, P, N, dtype, bc_dtype, seed=3):
    """x · 0.5, dt ∈ [0.01, 0.2], A ∈ −[0.5, 2], B/C · 0.3, as in
    test_kernels.py."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt: torch.from_numpy(np.asarray(a, np.float32)).to(
        device=device, dtype=dt)
    return (t(rng.standard_normal((B, nc, c, H, P)) * 0.5, dtype),
            t(rng.uniform(0.01, 0.2, (B, nc, c, H)), torch.float32),
            t(-rng.uniform(0.5, 2.0, (H,)), torch.float32),
            t(rng.standard_normal((B, nc, c, N)) * 0.3, bc_dtype),
            t(rng.standard_normal((B, nc, c, N)) * 0.3, bc_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bc_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B,nc,c,H,P,N", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda_device, dtype, bc_dtype, B, nc, c, H,
                                  P, N):
    args = _ssd_inputs(cuda_device, B, nc, c, H, P, N, dtype, bc_dtype)
    before = SSD.launches
    kind = SSD.design(dtype, bc_dtype, c, P, N)
    by_design = SSD.design_launches[kind]
    y, st = SSD.ssd_chunk_cuda(*args)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    assert SSD.design_launches[kind] == by_design + 1
    wy, wst = SSD.ssd_chunk_plain(*args)
    assert y.dtype == dtype and y.shape == args[0].shape
    assert st.dtype == torch.float32 and st.shape == (B, nc, H, N, P)
    _close_ssd(y, wy, dtype)
    _close_ssd(st, wst, dtype)


def _close_ssd(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **SSD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,nc,c,H,P,N", [(2, 2, 32, 4, 16, 8),
                                          (1, 2, 128, 8, 64, 128),
                                          (1, 4, 128, 8, 64, 128)])
def test_ssd_kernel_reads_column_slices(cuda_device, B, nc, c, H, P, N):
    """x, B and C as column slices of one wider tensor, the way the model
    splits the conv output: read in place (the Hopper design's tensor maps
    at the slice's row stride), the same bits as contiguous."""
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, B, nc, c, H, P, N,
                                   torch.bfloat16, torch.bfloat16)
    wide = torch.cat([x.reshape(B, nc, c, H * P), Bm, Cm], dim=-1)
    xs = wide[..., :H * P].reshape(B, nc, c, H, P)
    bs, cs = wide[..., H * P:H * P + N], wide[..., H * P + N:]
    assert not (xs.is_contiguous() or bs.is_contiguous())
    got = SSD.ssd_chunk_cuda(xs, dt, A, bs, cs)
    want = SSD.ssd_chunk_cuda(x, dt, A, Bm, Cm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,nc,c,H,P,N", [(4, 8, 128, 32, 64, 128),
                                          (4, 8, 128, 112, 64, 64),
                                          (1, 4, 128, 8, 64, 128),
                                          (2, 4, 16, 16, 32, 32)])
def test_ssd_kernel_is_bitwise_repeatable(cuda_device, B, nc, c, H, P, N):
    """Two launches of the Hopper design on the same inputs give the same
    bits: every output element is written by one block, without atomics
    (whole tiles, split tiles, one role)."""
    args = _ssd_inputs(cuda_device, B, nc, c, H, P, N, torch.bfloat16,
                       torch.bfloat16)
    assert SSD.design(torch.bfloat16, torch.bfloat16, c, P, N) == "hopper"
    first = SSD.ssd_chunk_cuda(*args)
    second = SSD.ssd_chunk_cuda(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,nc,c,H,P,N", [(1, 4, 128, 8, 64, 128),
                                          (1, 4, 128, 16, 64, 64),
                                          (2, 4, 128, 28, 64, 64),
                                          (2, 4, 64, 8, 32, 64)])
@pytest.mark.parametrize("grid", [1, 3])
def test_ssd_hopper_kernel_at_any_grid(cuda_device, B, nc, c, H, P, N, grid):
    """The Hopper design at a persistent grid other than the schedule's
    gives the schedule's bits: one block walks every tile back to back,
    or an odd grid hands a block of split tiles both roles in turn (at
    N 64 role 1 stores no state, so its heads commit one bulk group)."""
    args = _ssd_inputs(cuda_device, B, nc, c, H, P, N, torch.bfloat16,
                       torch.bfloat16)
    assert SSD.design(torch.bfloat16, torch.bfloat16, c, P, N) == "hopper"
    want = SSD.ssd_chunk_cuda(*args)
    got = SSD.ssd_chunk_cuda(*args, grid=grid)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ssd_hopper_layout_is_the_kernels(cuda_device):
    """``hopper_layout`` is the shared memory the built kernel asks for
    (its ``Cfg``), for every instantiation."""
    query = SSD._build.load("ssd_chunk").ssd_chunk_hopper_smem
    query.restype = ctypes.c_int
    query.argtypes = [ctypes.c_int] * 4
    for c, nwg in ((128, 2), (128, 1), (64, 1)):
        for P in (32, 64):
            for N in (64, 128):
                assert query(c, P, N, nwg) == \
                    SSD.hopper_layout(c, P, N, nwg)["total"], (c, P, N, nwg)
    assert query(128, 64, 128, 3) == -1


@pytest.mark.cuda
def test_ssd_cuda_route_raises_under_grad(cuda_device):
    args = _ssd_inputs(cuda_device, 1, 1, 16, 2, 32, 16, torch.float32,
                       torch.float32)
    args[0].requires_grad_(True)
    before = SSD.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd_chunk(*args)
    assert SSD.launches == before
    with torch.no_grad():
        ops.ssd_chunk(*args)
    assert SSD.launches == before + 1
    with pytest.raises(ValueError, match="chunks up to"):
        with torch.no_grad():
            SSD.ssd_chunk_cuda(*_ssd_inputs(cuda_device, 1, 1, 160, 2, 32, 16,
                                            torch.float32, torch.float32))
    # the tensor-core route: N and P at most 128
    with pytest.raises(ValueError, match="N and P up to 128"):
        SSD.ssd_chunk_cuda(*_ssd_inputs(cuda_device, 1, 1, 64, 2, 32, 160,
                                        torch.bfloat16, torch.bfloat16))
    assert SSD.launches == before + 1


@pytest.mark.cuda
def test_ssm_prefill_launches_once_per_layer_and_matches_plain(cuda_device):
    cfg = get_arch("mamba2-370m").reduced()
    params = init_params(cfg, 0, cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64))).to(cuda_device)
    before = SSD.launches
    got, cache = prefill(cfg.with_(use_ssd_kernel=True), params,
                         {"tokens": tokens})
    assert SSD.launches == before + cfg.n_layers
    want, want_cache = prefill(cfg, params, {"tokens": tokens})
    _close(got, want, torch.bfloat16)
    for name in ("conv", "ssd"):
        _close(cache["ssm"][name], want_cache["ssm"][name], torch.bfloat16)
    # layer 0's conv state is its pre-conv input, before any SSD
    assert torch.equal(cache["ssm"]["conv"][0], want_cache["ssm"]["conv"][0])


# ---- the slot server: one captured chunk of ragged decode steps ------------
SLOT_ARRIVALS = np.array([0, 0, 1, 3, 6, 9, 9])


def _slot_world(device, arch, **over):
    cfg = get_arch(arch).reduced().with_(**over)
    params = init_params(cfg, 0, device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (7, 32))
    return cfg, params, prompts


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over,kernel", [
    ("qwen2-0.5b", dict(use_flash_attention=True), FA),
    ("mamba2-370m", dict(use_ssd_kernel=True), SSD)])
def test_slot_graph_route_matches_eager_bitwise(cuda_device, arch, over,
                                                kernel):
    """The captured chunk against the same steps run eagerly on the card:
    tokens, schedule and TTFT equal; one capture across two serves; every
    admission's prefill through the kernel."""
    cfg, params, prompts = _slot_world(cuda_device, arch, **over)
    slots = SlotConfig(n_slots=3, ctx_len=40, steps_per_launch=4)
    graph = SlotServer(cfg, slots, device=cuda_device)
    eager = SlotServer(cfg, slots, device=cuda_device, capture=False)
    for admission in ("pure", "fedbuff:b=2"):
        before = kernel.launches
        got = graph.serve(params, prompts, 8, admission=admission,
                          arrivals=SLOT_ARRIVALS)
        assert kernel.launches == before + 7 * cfg.n_layers
        want = eager.serve(params, prompts, 8, admission=admission,
                           arrivals=SLOT_ARRIVALS)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.ttft_steps, want.ttft_steps)
        np.testing.assert_array_equal(got.schedule.workers,
                                      want.schedule.workers)
        assert got.tap_rows == got.decode_steps == want.decode_steps
        assert got.chunk_device_ms > 0 and np.all(got.tokens >= 0)
    assert graph.compile_counts() == {"chunk": 1}
    assert eager.compile_counts() == {"chunk": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("zamba2-7b", 7),
                                         ("deepseek-moe-16b", 2)])
def test_new_families_slot_graph_route_matches_eager_bitwise(cuda_device,
                                                             arch, layers):
    """The hybrid (one insertion of the shared block and a 1-layer tail)
    and the MoE at full width and reduced depth, with their kernels on:
    the captured chunk's tokens equal the eager steps' bit for bit (the
    MoE's combine is deterministic), and every admission's prefill
    launches the flash kernel once per attention block."""
    cfg = get_arch(arch).with_(n_layers=layers, use_flash_attention=True,
                               use_ssd_kernel=True)
    params = init_params(cfg, 0, cuda_device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (7, 32))
    slots = SlotConfig(n_slots=3, ctx_len=40, steps_per_launch=4)
    graph = SlotServer(cfg, slots, device=cuda_device)
    before = FA.launches
    got = graph.serve(params, prompts, 8, arrivals=SLOT_ARRIVALS)
    n_attn = layers // cfg.attn_every if cfg.family == "hybrid" else layers
    assert FA.launches == before + 7 * n_attn
    again = graph.serve(params, prompts, 8, arrivals=SLOT_ARRIVALS)
    want = SlotServer(cfg, slots, device=cuda_device, capture=False).serve(
        params, prompts, 8, arrivals=SLOT_ARRIVALS)
    np.testing.assert_array_equal(got.tokens, again.tokens)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert graph.compile_counts() == {"chunk": 1} and np.all(got.tokens >= 0)


@pytest.mark.cuda
def test_slot_admission_rotation_isolates_slots(cuda_device):
    """Seven requests rotate through three slots; each must decode exactly
    as it does alone in the same three-slot pool (the same decode shapes),
    so no admission leaks into a neighbour's cache row.  f32, TF32 off."""
    cfg, params, prompts = _slot_world(cuda_device, "qwen2-0.5b",
                                       dtype="float32",
                                       use_flash_attention=True)
    srv = SlotServer(cfg, SlotConfig(n_slots=3, ctx_len=40,
                                     steps_per_launch=4), device=cuda_device)
    res = srv.serve(params, prompts, 8, arrivals=SLOT_ARRIVALS)
    for rid in range(7):
        alone = srv.serve(params, prompts[rid:rid + 1], 8)
        np.testing.assert_array_equal(res.tokens[rid:rid + 1], alone.tokens,
                                      err_msg=f"request {rid}")
    assert srv.compile_counts() == {"chunk": 1}


@pytest.mark.cuda
def test_snapshot_copy_isolates_the_offered_state(cuda_device, tmp_path):
    """``offer`` copies on the current stream before the next in-place
    update and fetches on a side stream: three offers, each followed at
    once by an in-place update on the current stream, restore as offered;
    the device and pinned host buffers are allocated once, two deep."""
    from repro_torch.checkpoint import AsyncSnapshotter, restore

    snap = AsyncSnapshotter(str(tmp_path), 1, keep=3)
    w = torch.zeros((1024, 1024), dtype=torch.bfloat16, device=cuda_device)
    m = torch.zeros(4096, dtype=torch.float32, device=cuda_device)
    for r in (1, 2, 3):
        w.fill_(r)
        m.fill_(10 * r)
        snap.offer(r, {"w": w, "opt": {"m": m}})
        if r == 1:
            first = snap._buffers[0]
        for _ in range(4):                  # the next chunk, in place
            w.mul_(3).add_(1)
            m.add_(w[0, :1].float().expand(4096))
    assert snap.drain() == 3
    assert all(p[1]["w"].is_pinned() for p in snap._buffers)
    for r in (1, 2, 3):
        got = restore(snap.round_dir(r), {"w": w, "opt": {"m": m}})
        assert got["w"].device == w.device
        assert torch.equal(got["w"], torch.full_like(w, r))
        assert torch.equal(got["opt"]["m"], torch.full_like(m, 10 * r))
    assert snap._buffers[0] is first        # reused, not reallocated


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [
    ("qwen2-0.5b", dict(use_flash_attention=True)),
    ("mamba2-370m", dict(use_ssd_kernel=True))])
def test_slot_resume_into_a_fresh_capture_bitwise(cuda_device, tmp_path,
                                                  arch, over):
    """A serve preempted after a snapshot resumes on a fresh server (a new
    capture, the snapshot copied into the lanes' tensors): tokens and TTFT
    equal the uninterrupted serve bit for bit.  On the dense family a
    poisoned request also retries through prefix replay (prefill at
    32 + e tokens), on the graph route as on the eager one."""
    from repro_torch.checkpoint import AsyncSnapshotter
    from repro_torch.distributed import RetryPolicy, ServePreempted
    from repro_torch.faults import ServeFaults

    cfg, params, prompts = _slot_world(cuda_device, arch, **over)
    slots = SlotConfig(n_slots=3, ctx_len=48, steps_per_launch=4)
    clean = SlotServer(cfg, slots, device=cuda_device).serve(
        params, prompts, 8, arrivals=SLOT_ARRIVALS)
    faults = ServeFaults(preempt_steps=(8,))
    with pytest.raises(ServePreempted):
        SlotServer(cfg, slots, device=cuda_device).serve(
            params, prompts, 8, arrivals=SLOT_ARRIVALS, faults=faults,
            snapshot=AsyncSnapshotter(str(tmp_path), 4))
    r, latest = AsyncSnapshotter.latest(str(tmp_path))
    fresh = SlotServer(cfg, slots, device=cuda_device)
    res = fresh.serve(params, prompts, 8, arrivals=SLOT_ARRIVALS,
                      faults=faults, resume_from=latest)
    assert res.resumed_from == r == 8
    assert fresh.compile_counts() == {"chunk": 1}
    np.testing.assert_array_equal(res.tokens, clean.tokens)
    np.testing.assert_array_equal(res.ttft_steps, clean.ttft_steps)
    if cfg.family != "dense":
        return
    kw = dict(arrivals=SLOT_ARRIVALS, faults=ServeFaults(poisons=((2, 5),)),
              retry=RetryPolicy(max_attempts=2, backoff_base=2))
    graph = SlotServer(cfg, slots, device=cuda_device).serve(
        params, prompts, 8, **kw)
    eager = SlotServer(cfg, slots, device=cuda_device, capture=False).serve(
        params, prompts, 8, **kw)
    assert graph.attempts == {2: 1} and graph.evictions == {}
    np.testing.assert_array_equal(graph.tokens, eager.tokens)
    assert np.all(graph.tokens >= 0)


# ---- the theory tier: CUDA graph chunks of the exact replay ----------------
SIM_GRID = (0.005, 0.002, 0.0005)


def _sim_problem(device, **kw):
    A, b = make_synthetic(1.0, 1.0, n=8, m=40, d=30, seed=0)
    return LogRegProblem(A, b, lam=0.1, device=device, **kw)


def _sim_spec(prob, **kw):
    base = dict(scheduler="shuffled", timing="poisson:slow=8", objective=prob,
                T=250, stepsize=SIM_GRID, log_every=10, seed=0)
    return ExperimentSpec(**{**base, **kw})


def _same_run(a, b):
    for f in ("x", "xs", "grad_norms", "losses"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic,clip", [(False, None), (True, None),
                                             (False, 0.05)])
def test_replay_graph_route_matches_eager_bitwise(cuda_device, stochastic,
                                                  clip):
    """T = 250 at 100 steps per graph: two full chunks and a tail."""
    prob = _sim_problem(cuda_device, batch_size=10)
    spec = _sim_spec(prob, stochastic=stochastic, clip=clip)
    graph = SimulatorBackend(cuda_device).run(spec)
    eager = SimulatorBackend(cuda_device, capture=False).run(spec)
    assert graph.extra["runtime"] == "graph"
    assert graph.extra["graph_replays"] == 3
    assert graph.extra["chunk_steps"] == 100
    assert graph.extra["host_syncs"] == 1
    assert eager.extra["runtime"] == "eager"
    _same_run(graph, eager)
    for g in SIM_GRID:
        np.testing.assert_array_equal(graph.grid[g]["grad_norms"],
                                      eager.grid[g]["grad_norms"])


@pytest.mark.cuda
def test_replay_grid_matches_solo_replays_bitwise(cuda_device):
    prob = _sim_problem(cuda_device)
    s = _sim_spec(prob).build_schedule()
    x0 = np.zeros(prob.d, np.float32)
    kw = dict(log_every=10, full_grad_fn=prob.full_grad, loss_fn=prob.loss,
              device=cuda_device)
    batched = replay_grid(s, prob.grad_fn(), x0, SIM_GRID, **kw)
    for g, res in zip(SIM_GRID, batched):
        _same_run(res, replay(s, prob.grad_fn(), x0, g, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [False, True])
def test_replay_card_matches_cpu(cuda_device, stochastic):
    spec = _sim_spec(_sim_problem(cuda_device, batch_size=10),
                     stochastic=stochastic)
    card = run(spec, device=cuda_device)
    cpu = run(_sim_spec(_sim_problem("cpu", batch_size=10),
                        stochastic=stochastic), device="cpu")
    assert card.gamma == cpu.gamma
    for f in ("x", "xs", "grad_norms", "losses"):
        np.testing.assert_allclose(getattr(card, f), getattr(cpu, f),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_simulator_refuses_an_objective_on_another_device(cuda_device):
    with pytest.raises(ValueError, match="live on cpu"):
        SimulatorBackend(cuda_device).run(_sim_spec(_sim_problem("cpu")))


def _launch_tallies(cfg, shape, device, **kw):
    """(meta tally, card tally, kernel launches during the card's) of one
    ``dryrun.build_step`` step."""
    meta_fn, meta_args = dryrun.build_step(cfg, shape, "meta", **kw)
    meta = op_cost.analyze(meta_fn, *meta_args)
    fn, args = dryrun.build_step(cfg, shape, device, **kw)
    fn(*args)                                      # warm: builds the kernels
    before = {"flash_attention": FA.launches, "ssd_chunk": SSD.launches,
              **AU.launches}
    card = op_cost.analyze(fn, *args)
    torch.cuda.synchronize()
    after = {"flash_attention": FA.launches, "ssd_chunk": SSD.launches,
             **AU.launches}
    return meta, card, {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}


@pytest.mark.cuda
def test_launch_tier_meta_tally_equals_card_train(cuda_device):
    """A reduced pooled training round: the meta trace's dot flops, bytes
    and kernel rows equal the card's tally; the update kernel is tallied
    once per launch (one per dtype pool)."""
    cfg = get_arch("qwen2-0.5b").reduced()
    meta, card, launched = _launch_tallies(
        cfg, smoke_shape("train"), cuda_device,
        update_impl="pallas_pooled", n_groups=2)
    assert (card.dot_flops, card.hbm_bytes) == (meta.dot_flops,
                                                meta.hbm_bytes)
    assert card.kernels == meta.kernels
    assert launched == {"fused_adam_delayed":
                        card.kernels["fused_adam_delayed"][0]} != {}


@pytest.mark.cuda
def test_launch_tier_meta_tally_equals_card_prefill_kernels(cuda_device):
    """A reduced hybrid prefill with flash and SSD on: equal tallies, each
    kernel tallied once per launch (flash per shared-attention insertion,
    SSD per Mamba2 layer)."""
    cfg = get_arch("zamba2-7b").reduced().with_(use_flash_attention=True,
                                                use_ssd_kernel=True)
    meta, card, launched = _launch_tallies(
        cfg, InputShape("prefill", 64, 2, "prefill"), cuda_device)
    assert (card.dot_flops, card.hbm_bytes) == (meta.dot_flops,
                                                meta.hbm_bytes)
    assert card.kernels == meta.kernels
    assert launched == {k: v[0] for k, v in card.kernels.items()}
    assert set(launched) == {"flash_attention", "ssd_chunk"}


@pytest.mark.cuda
def test_replay_capture_failure_raises_without_fallback(cuda_device):
    """A gradient that reads the device inside the captured chunk makes the
    capture fail; the replay raises instead of running the eager loop.
    (Last in the file: a failed capture is left behind.)"""
    prob = _sim_problem(cuda_device)
    s = _sim_spec(prob).build_schedule()
    calls = []

    def syncing_grad(x, w, idx):
        calls.append(float(x.sum()))            # a host read
        return prob.grad_fn()(x, w, idx)

    with pytest.raises(RuntimeError):
        replay(s, syncing_grad, np.zeros(prob.d, np.float32), 0.005,
               device=cuda_device)
    assert len(calls) <= 2      # the warm-up step and the failed capture
