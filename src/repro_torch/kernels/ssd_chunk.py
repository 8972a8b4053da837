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
  the CUDA cores.  On the tensor cores the layout picks the design
  (:func:`design`): "hopper" (TMA-fed tiles, wgmma, a producer warp; every
  model path) wherever tensor maps describe x, B and C, else "mma_sync",
  the first tensor-core kernel; :data:`design_launches` counts each.
  :func:`schedule` sizes the Hopper design's work tiles and grid, and
  :func:`tile_walk` is the kernel's walk over them.  The kernel is forward
  only, as the TPU kernel is: with grad mode on and an input that requires
  grad it raises rather than return a tensor without the gradient.
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
#: the same launches by design ("hopper", "mma_sync", "cuda_cores"); set
#: the values to 0 beside ``launches``
design_launches = {"hopper": 0, "mma_sync": 0, "cuda_cores": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limits (csrc/ssd_chunk.cu): chunk length, padded products
#: of the CUDA-core route, state size and head dim of the tensor-core route
MAX_CHUNK, MAX_TILE_ELEMS, MAX_SMEM = 128, 16384, 232448
TC_MAX_N = TC_MAX_P = 128
#: heads per block of the mma.sync design, which shares C·Bᵀ among them
HEADS_PER_BLOCK = 4
#: the Hopper design's widest head dim (its registers hold y's 64 columns)
HOPPER_MAX_P = 64
#: an H100's shared memory per SM and reserved per block (bytes)
SM_SMEM, BLOCK_RESERVED = 233472, 1024


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


def design(x_dtype, bc_dtype, c, P, N, x_rs=None, b_rs=None, c_rs=None,
           aligned=True) -> str:
    """Which kernel a call with these dtypes, shape and layout takes: the
    CUDA cores for any f32 operand (:func:`route`); for bf16 x, B and C the
    Hopper design ("hopper") where tensor maps describe them — c and N up
    to 128, P up to 64 and a multiple of 8, row strides (elements between
    consecutive rows; contiguous when None) multiples of 8, every pointer
    16-byte aligned — else the first tensor-core kernel ("mma_sync").  The
    wrapper asks it before every launch, from the layout alone."""
    if route(x_dtype, bc_dtype) == "cuda_cores":
        return "cuda_cores"
    rows = (P if x_rs is None else x_rs, N if b_rs is None else b_rs,
            N if c_rs is None else c_rs)
    if c <= MAX_CHUNK and N <= TC_MAX_N and P <= HOPPER_MAX_P and P % 8 == 0 \
            and all(r % 8 == 0 for r in rows) and aligned:
        return "hopper"
    return "mma_sync"


def _round(n, m):
    return -(-n // m) * m


def hopper_layout(c, P, N, nwg):
    """The Hopper design's shared memory for (c, P, N) with ``nwg`` consumer
    warpgroups, as ``Cfg`` in csrc/ssd_chunk.cu lays it out: c padded to 64
    or 128 rows, N to 64 or 128 and P to 32 or 64 columns; the B and C
    tiles (C all rows with two warpgroups, a role's 64 with one), a ring
    of x stages (3, or 2 with one warpgroup), y's 64-row staging per
    warpgroup and the state's 8 KB store boxes (64 rows × 32 f32) the roles
    fill, both twice with two warpgroups (a head's stores drain while the
    next computes), 12 bytes a row per stage for the decay terms, and 1 KB
    for the base's alignment.  Returns its parts and ``total`` (bytes)."""
    cp, np_, pp = (128 if c > 64 else 64), (128 if N > 64 else 64), \
        (64 if P > 32 else 32)
    nb, roles = np_ // 64, cp // 64
    # state blocks a staging buffer holds: both roles' with two warpgroups,
    # else a role's (role r's r-th, or all of them with one role)
    blocks = nb if nwg == 2 or roles == 1 else 1
    stages, sbuf = (3, 2) if nwg == 2 else (2, 1)
    crows = cp if nwg == 2 else 64
    parts = dict(b=nb * cp * 128, c=nb * crows * 128,
                 x=stages * cp * 128, y=sbuf * nwg * 64 * 128,
                 state=sbuf * blocks * pp // 32 * 8192,
                 aux=stages * cp * 12)
    return dict(parts, stages=stages, cp=cp, np=np_, pp=pp,
                total=1024 + sum(parts.values()))


def smem_bytes(c, P, N, tensor_cores=False):
    """Shared memory one block takes for (c, P, N), as the route lays it
    out.  CUDA cores: cum and the end decays (c each), x·dt (c × P+1), the
    scores (c × c+1) and the staging buffer, all float32, padded to whole
    4 × 4 tiles.  Tensor cores: the Hopper design's layout
    (:func:`hopper_layout`, at its widest: two consumer warpgroups where
    c > 64) for P up to 64; beyond, the mma.sync design's — sizes padded
    to 16 and bf16 rows padded by 8: the B tile, two x stages, the f32
    C·Bᵀ triangle (1 KB per 16 × 16 block; it first holds the staged C
    tile, so it is at least that size) and 12 bytes per row for each of
    the block's heads."""
    if tensor_cores and P <= HOPPER_MAX_P:
        return hopper_layout(c, P, N, 2 if c > 64 else 1)["total"]
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


def schedule(G, H, c, P, N, sms):
    """The Hopper design's work tiles for G cells of H heads on ``sms``
    SMs: ``nwg`` consumer warpgroups a block, ``hg`` heads a tile,
    ``split`` (tiles of one (cell, head, role)), ``tiles`` and ``grid``
    (persistent blocks).  With two roles (c > 64) a block runs both with
    two warpgroups, and ``hg`` is the fewest heads a tile that keeps the
    tiles within the SMs, evened over H; where even one head a tile leaves
    SMs idle (G·H < sms) each (cell, head) splits into its two roles, a
    tile each, on blocks of one warpgroup, two an SM.  One role (c ≤ 64):
    blocks of one warpgroup, two an SM, tiles as for two roles."""
    pairs = G * H
    if c > 64 and pairs < sms:
        tiles = 2 * pairs
        return dict(nwg=1, split=1, hg=1, tiles=tiles,
                    grid=min(tiles, sms * _blocks_per_sm(c, P, N, 1)))
    nwg = 2 if c > 64 else 1
    slots = sms * _blocks_per_sm(c, P, N, nwg)
    want = min(-(-pairs // slots), H)   # heads a tile: tiles within the slots
    hg = -(-H // -(-H // want))         # the same number of groups, evened
    tiles = G * -(-H // hg)             # the kernel's tiles: G × ceil(H / hg)
    return dict(nwg=nwg, split=0, hg=hg, tiles=tiles, grid=min(tiles, slots))


def _blocks_per_sm(c, P, N, nwg):
    """Blocks of the Hopper design an SM holds at once: one with two
    consumer warpgroups, two with one where their shared memory fits."""
    if nwg == 2:
        return 1
    per = hopper_layout(c, P, N, 1)["total"] + BLOCK_RESERVED
    return 2 if 2 * per <= SM_SMEM else 1


def role_parts(c, P, N, role):
    """The outputs role ``role`` of a (cell, head) writes in the Hopper
    design: ``("y", r)`` for y's rows 64r … 64r + 63 and ``("state", b)``
    for the state's rows 64b … 64b + 63.  Role r takes y's block r and the
    state's block r; one role (c ≤ 64) takes every block.  The roles of a
    (cell, head) partition y and the state (``Cfg`` in csrc/ssd_chunk.cu)."""
    nb = hopper_layout(c, P, N, 1)["np"] // 64
    if c <= 64:
        return [("y", 0)] + [("state", b) for b in range(nb)]
    return [("y", role)] + [("state", role)] * (role < nb)


def tile_walk(sched, G, H, c):
    """The kernel's walk (``tile_of`` in csrc/ssd_chunk.cu) in Python: for
    each persistent block, the (cell, head, role) its consumer warpgroups
    take, tile by tile, in order."""
    roles = (0, 1) if c > 64 else (0,)
    n_hg = -(-H // sched["hg"])
    walk = {}
    for b in range(sched["grid"]):
        out = walk.setdefault(b, [])
        for w in range(b, sched["tiles"], sched["grid"]):
            if sched["split"]:
                cell, h = divmod(w >> 1, H)
                out.append((cell, h, w & 1))
                continue
            cell, k = divmod(w, n_hg)
            h0 = k * sched["hg"]
            for h in range(h0, min(H, h0 + sched["hg"])):
                out.extend((cell, h, r) for r in roles)
    return walk


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _operands(x, B_, C_):
    """x, B and C as the kernel reads them (:func:`_rows`), each with its
    row stride, and the design the call takes (:func:`design`)."""
    (x, x_rs), (B_, b_rs), (C_, c_rs) = _rows(x, 2), _rows(B_, 1), _rows(C_, 1)
    kind = design(x.dtype, B_.dtype, x.shape[2], x.shape[4], B_.shape[-1],
                  x_rs, b_rs, c_rs,
                  aligned=all(t.data_ptr() % 16 == 0 for t in (x, B_, C_)))
    return (x, x_rs), (B_, b_rs), (C_, c_rs), kind


def design_of(x, B_, C_) -> str:
    """The design a call on these x, B and C takes, from their dtypes,
    shapes and layout (any device: it reads no data)."""
    return _operands(x, B_, C_)[3]


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
    """The C entry point of the CUDA-core and mma.sync kernels, built and
    bound on first use."""
    fn = _build.load("ssd_chunk").ssd_chunk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    return fn


@functools.cache
def _hopper_kernel():
    """The C entry point of the Hopper design (same library)."""
    fn = _build.load("ssd_chunk").ssd_chunk_hopper
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    return fn


def ssd_chunk_cuda(x, dt, A, B_, C_, grid=None):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    x, B_ and C_ are read in place when their rows are uniformly strided
    (the model's column slices of the conv output are); dt and A are made
    contiguous.  Allocates only the outputs.  Raises on what the kernel does
    not take, when the launch is refused, and under grad (no backward).
    ``grid`` sets the Hopper design's persistent blocks (default
    :func:`schedule`'s); every grid writes the same bits."""
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
    (x, x_rs), (B_, b_rs), (C_, c_rs), kind = _operands(x, B_, C_)
    dt, A = dt.contiguous(), A.contiguous()
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), y.data_ptr(), st.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "hopper":
            sched = schedule(G, H, c, P, N, _sm_count(x.device.index))
            err = _hopper_kernel()(*ptrs, G, c, H, P, N, x_rs, b_rs, c_rs,
                                   sched["nwg"], sched["hg"], sched["split"],
                                   grid or sched["grid"], stream)
        else:
            err = _kernel()(*ptrs, G, c, H, P, N, x_rs, b_rs, c_rs,
                            _DTYPE_CODES[x.dtype], _DTYPE_CODES[B_.dtype],
                            stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed ({kind}): "
                           f"cudaError_t {err}")
    launches += 1
    design_launches[kind] += 1
    return y, st
