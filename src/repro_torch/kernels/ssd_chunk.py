"""Mamba2 SSD intra-chunk kernel: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``repro/kernels/ssd_chunk.py``.  The kernel itself is
``csrc/ssd_chunk.cu`` (CUDA C++ for ``sm_90a``), built at first use by
``kernels/_build.py`` and called through ``ctypes``.

Per (batch, chunk, head), with n_groups = 1 (B and C shared by the heads)::

    L      = exp(segsum(dt·A))           (c, c) lower-triangular decay
    y      = ((C Bᵀ) ∘ L) (x·dt)         (c, P), in x's dtype
    state  = (B · decay_to_end)ᵀ (x·dt)  (N, P), float32

Shapes are the JAX kernel's: x (B,nc,c,H,P), dt (B,nc,c,H), A (H,),
B_/C_ (B,nc,c,N) → y (B,nc,c,H,P), states (B,nc,H,N,P).

* :func:`ssd_chunk_cuda` launches the kernel on CUDA tensors and adds one
  to :data:`launches` per launch.  The dtypes pick the kernel's route
  (:func:`route`): bf16 x, B and C on the tensor cores, every other mix on
  the CUDA cores.  The kernel is forward only, as the TPU
  kernel is: with grad mode on and an input that requires grad it raises
  rather than return a tensor without the gradient.
* :func:`ssd_chunk_plain` is the same function in plain PyTorch: the CPU
  path, and the yardstick the kernel is held to on the card.  It stays
  differentiable.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

F32 = torch.float32

#: kernel launches since the counter was last set; the main path's proof
#: that prefill went through the kernel (set it to 0, run, read it)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limits (csrc/ssd_chunk.cu): chunk length, padded products
#: of the CUDA-core route, state size and head dim of the tensor-core route
MAX_CHUNK, MAX_TILE_ELEMS, MAX_SMEM = 128, 16384, 232448
TC_MAX_N = TC_MAX_P = 128
#: heads per block of the tensor-core route, which shares C·Bᵀ among them
HEADS_PER_BLOCK = 4


def route(x_dtype, bc_dtype) -> str:
    """Which of the kernel's two routes operands of these dtypes take: bf16
    x, B and C (the model's path) run on the tensor cores, C·Bᵀ shared by a
    block's heads and the f32 factors rounded to bf16 hi + lo; any other
    mix keeps the f32 arithmetic of the first version."""
    for dt in (x_dtype, bc_dtype):
        if dt not in _DTYPE_CODES:
            raise TypeError(f"ssd_chunk takes float32 or bfloat16, got {dt}")
    if x_dtype == bc_dtype == torch.bfloat16:
        return "tensor_cores"
    return "cuda_cores"


def _round(n, m):
    return -(-n // m) * m


def smem_bytes(c, P, N, tensor_cores=False):
    """Shared memory one block takes for (c, P, N), as the route lays it
    out.  CUDA cores: cum and the end decays (c each), x·dt (c × P+1), the
    scores (c × c+1) and the staging buffer, all float32, padded to whole
    4 × 4 tiles.  Tensor cores, sizes padded to 16 and bf16 rows padded by
    8: the B tile, two x stages, the f32 C·Bᵀ triangle (1 KB per 16 × 16
    block; it first holds the staged C tile, so it is at least that size)
    and 12 bytes per row for each of the block's heads."""
    if tensor_cores:
        cp, np_, pp = _round(c, 16), _round(N, 16), _round(P, 16)
        nrt = cp // 16
        tile = 2 * cp * (np_ + 8)
        return (tile + 4 * cp * (pp + 8)
                + max(nrt * (nrt + 1) // 2 * 1024, tile)
                + HEADS_PER_BLOCK * cp * 12)
    cp, pp, np_ = _round(c, 4), _round(P, 4), _round(N, 4)
    return 4 * (2 * cp + cp * (pp + 1) + cp * (cp + 1)
                + max(2 * cp * 33, 32 * (np_ + 1)))


def ssd_chunk_plain(x, dt, A, B_, C_):
    """The Pallas body in plain PyTorch, float32 throughout, y cast once.
    Both outputs are contiguous, as the kernel's are, so what the model
    does with them (a reshape copies a strided tensor) does not depend on
    the route."""
    c = x.shape[2]
    xf, dtf = x.to(F32), dt.to(F32)
    Bf, Cf = B_.to(F32), C_.to(F32)
    cum = torch.cumsum(dtf * A.to(F32), dim=2)                 # (B,nc,c,H)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nc,i,j,H)
    tril = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    # exp only where j <= i (−inf elsewhere): no inf reaches the product
    L = torch.exp(diff.masked_fill(~tril[:, :, None], float("-inf")))
    xdt = xf * dtf[..., None]                                  # (B,nc,c,H,P)
    scores = torch.einsum("bkin,bkjn->bkij", Cf, Bf)
    y = torch.einsum("bkij,bkijh,bkjhp->bkihp", scores, L, xdt)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,c,H)
    states = torch.einsum("bkjn,bkjh,bkjhp->bkhnp", Bf, decay_to_end, xdt)
    return y.to(x.dtype).contiguous(), states.contiguous()


def _rows(t, inner: int):
    """``(t, row stride)``: ``t`` read as rows over its leading dims, each
    row its last ``inner`` dims contiguous, rows at one uniform stride (a
    column slice of a larger tensor qualifies).  Other layouts are copied
    to a contiguous tensor first."""
    lead = t.dim() - inner
    row, ok = 1, True
    for d in range(t.dim() - 1, lead - 1, -1):
        ok = ok and (t.shape[d] == 1 or t.stride(d) == row)
        row *= t.shape[d]
    rs = expect = None
    for d in range(lead - 1, -1, -1):
        if t.shape[d] == 1:
            continue
        if expect is None:
            rs = expect = t.stride(d)
        ok = ok and t.stride(d) == expect
        expect *= t.shape[d]
    if rs is None:
        rs = row
    if not ok or rs < row:
        t, rs = t.contiguous(), row
    return t, rs


def _check(x, dt, A, B_, C_):
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (dt, A, B_, C_)):
        raise ValueError("ssd_chunk: every operand must lie on one CUDA device")
    if x.dtype not in _DTYPE_CODES or B_.dtype not in _DTYPE_CODES \
            or C_.dtype != B_.dtype:
        raise TypeError(f"ssd_chunk takes float32 or bfloat16 x and B = C "
                        f"dtypes, got {x.dtype}, {B_.dtype}, {C_.dtype}")
    if dt.dtype != F32 or A.dtype != F32:
        raise TypeError(f"ssd_chunk takes float32 dt and A, got {dt.dtype}, "
                        f"{A.dtype}")
    if x.dim() != 5:
        raise ValueError(f"want x (B,nc,c,H,P), got {tuple(x.shape)}")
    Bb, nc, c, H, P = x.shape
    N = B_.shape[-1]
    if dt.shape != (Bb, nc, c, H) or A.shape != (H,) or \
            B_.shape != (Bb, nc, c, N) or C_.shape != B_.shape:
        raise ValueError(f"ssd_chunk shapes do not match: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B_.shape)}, C {tuple(C_.shape)}")
    check_shape(c, P, N, route(x.dtype, B_.dtype) == "tensor_cores")


def check_shape(c: int, P: int, N: int, tensor_cores: bool) -> None:
    """Raise ``ValueError`` unless a route takes chunk length ``c``, head
    dim ``P`` and state size ``N`` (the kernel's shape arithmetic alone,
    so it can be asked without a CUDA tensor)."""
    if tensor_cores:
        if c > MAX_CHUNK or N > TC_MAX_N or P > TC_MAX_P \
                or smem_bytes(c, P, N, True) > MAX_SMEM:
            raise ValueError(f"ssd_chunk kernel takes chunks up to {MAX_CHUNK} "
                             f"rows with N and P up to {TC_MAX_N} in bf16; got "
                             f"c={c}, P={P}, N={N}")
        return
    cp, pp, np_ = _round(c, 4), _round(P, 4), _round(N, 4)
    if c > MAX_CHUNK or cp * pp > MAX_TILE_ELEMS or np_ * pp > MAX_TILE_ELEMS \
            or smem_bytes(c, P, N) > MAX_SMEM:
        raise ValueError(f"ssd_chunk kernel takes chunks up to {MAX_CHUNK} "
                         f"rows with c·P and N·P up to {MAX_TILE_ELEMS}; got "
                         f"c={c}, P={P}, N={N}")


@functools.cache
def _kernel():
    """The C entry point, built and bound on first use."""
    fn = _build.load("ssd_chunk").ssd_chunk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    return fn


def ssd_chunk_cuda(x, dt, A, B_, C_):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    x, B_ and C_ are read in place when their rows are uniformly strided
    (the model's column slices of the conv output are); dt and A are made
    contiguous.  Allocates only the outputs.  Raises on what the kernel does
    not take, when the launch is refused, and under grad (no backward)."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B_, C_)):
        raise NotImplementedError(
            "the SSD chunk kernel has no backward (the TPU kernel it "
            "replaces, ssd_chunk_pallas, has none either); run it under "
            "torch.no_grad(), or train with use_ssd_kernel=False")
    _check(x, dt, A, B_, C_)
    Bb, nc, c, H, P = x.shape
    N = B_.shape[-1]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    st = torch.empty((Bb, nc, H, N, P), dtype=F32, device=x.device)
    G = Bb * nc
    if G == 0:
        return y, st
    x, x_rs = _rows(x, 2)
    B_, b_rs = _rows(B_, 1)
    C_, c_rs = _rows(C_, 1)
    dt, A = dt.contiguous(), A.contiguous()
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                 C_.data_ptr(), y.data_ptr(), st.data_ptr(), G, c, H, P, N,
                 x_rs, b_rs, c_rs, _DTYPE_CODES[x.dtype],
                 _DTYPE_CODES[B_.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: cudaError_t {err}")
    launches += 1
    return y, st
