"""The port's CUDA kernels on the card, held to their plain versions.

Every test here is marked ``cuda`` and skips on a host without a card: the
kernels are CUDA C++ for ``sm_90a`` and have no CPU mode (the CPU tests hold
the plain versions to the Pallas kernels instead).  The file imports neither
JAX nor the JAX package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of the kernel suite, ``test_kernels.py``: flash and
the SGD and heavy-ball updates f32 2e-4, the Adam updates f32 rtol 1e-5 /
atol 1e-6, bf16 3e-2; the update kernels' buffer swap is bitwise; the SSD
kernel f32 1e-3, bf16 4e-2, and a prefill through it within bf16 3e-2 of
the einsum branch (``test_kernels.py:169-267``).

The slot server's tests hold its captured decode chunk to the same steps
run eagerly (tokens bit for bit) and each request of a rotation through
every slot to the same request served alone.

The theory tier has no kernel of its own: its replay runs torch ops as
CUDA graph chunks.  Its card tests hold the graph route to the eager loop
and a grid to solo replays bit for bit, and the card to the CPU within
``chip_smoke.py``'s rtol 1e-4 / atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (ExperimentSpec, SimulatorBackend,  # noqa: E402
                             TrainerBackend, TrainJob, run)
from repro_torch.configs import get_arch                   # noqa: E402
from repro_torch.core import replay, replay_grid           # noqa: E402
from repro_torch.distributed import SlotConfig, SlotServer  # noqa: E402
from repro_torch.kernels import async_update as AU         # noqa: E402
from repro_torch.kernels import flash_attention as FA      # noqa: E402
from repro_torch.kernels import ops                        # noqa: E402
from repro_torch.kernels import ssd_chunk as SSD           # noqa: E402
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


#: (B, nc, c, H, P, N): the kernel test matrix of test_kernels.py, ragged
#: sizes (no multiple of 4 or of 32), the serving path's prefill shape, and
#: the edges of the tensor-core route's tiling: one cell, H not a multiple
#: of the 4 heads a block takes, c = 32 and c = 128 with N = 64
SSD_CASES = [(1, 1, 16, 2, 32, 16), (1, 1, 64, 4, 64, 32),
             (2, 3, 13, 3, 20, 10), (4, 8, 128, 32, 64, 128),
             (1, 1, 128, 8, 64, 128), (1, 2, 64, 6, 64, 64),
             (2, 2, 32, 8, 64, 64), (2, 2, 128, 8, 64, 64),
             (1, 2, 16, 4, 64, 128),
             (1, 4, 128, 32, 64, 128)]          # the slot lane's admission
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
    y, st = SSD.ssd_chunk_cuda(*args)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    wy, wst = SSD.ssd_chunk_plain(*args)
    assert y.dtype == dtype and y.shape == args[0].shape
    assert st.dtype == torch.float32 and st.shape == (B, nc, H, N, P)
    _close_ssd(y, wy, dtype)
    _close_ssd(st, wst, dtype)


def _close_ssd(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **SSD_TOL[dtype])


@pytest.mark.cuda
def test_ssd_kernel_reads_column_slices(cuda_device):
    """x, B and C as column slices of one wider tensor, the way the model
    splits the conv output: read in place, same result as contiguous."""
    B, nc, c, H, P, N = 2, 2, 32, 4, 16, 8
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
