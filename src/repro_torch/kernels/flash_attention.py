"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/flash_attention.py``.  The kernel itself is
``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``), built at first use by
``kernels/_build.py`` and called through ``ctypes``.

* :func:`flash_attention_cuda` launches the kernel on a CUDA tensor and adds
  one to the module counter :data:`launches` per launch.  The dtype picks
  the kernel's route (:func:`route`): bf16 on the tensor cores (wgmma on
  TMA-fed tiles, a producer warp and an mbarrier ring), f32 on the CUDA
  cores.
* :func:`flash_attention_plain` is the same function in plain PyTorch: the
  CPU path, and the yardstick the kernel is held to on the card.

Semantics (those of the TPU kernel): masks use absolute positions, keys
from 0 and query row r at ``q_offset + r`` (causal ``kp <= qp``, window
``kp > qp − window``); a row with no visible key is 0; the output dtype is
``q.dtype``.  ``q_offset`` (default 0, the TPU kernel's function) lets q
be a block of rows of a longer sequence whose k / v are whole: a rank's
rows under sequence parallelism (``models/tp.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .ref import attention_mask, reference_attention

#: kernel launches since the counter was last set; the main path's proof
#: that prefill went through the kernel (set it to 0, run, read it)
launches = 0

#: the head dims the kernel is built for: every multiple of 16 up to 128
#: (csrc/flash_attention.cu ``dispatch_d``)
HEAD_DIMS = tuple(range(16, 129, 16))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's route for each dtype it takes (csrc/flash_attention.cu)
ROUTES = {torch.float32: "cuda_cores", torch.bfloat16: "tensor_cores"}


def route(dtype) -> str:
    """Which of the kernel's two routes q/k/v of ``dtype`` take: bf16 runs
    its products on the tensor cores (wgmma; P rounded to bf16 before
    P·V), f32 keeps the f32 FMAs of the first version, which hold the f32
    tolerance."""
    if dtype not in ROUTES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {dtype}")
    return ROUTES[dtype]


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          q_offset=0):
    """q: (B,Sq,H,D); k/v: (B,Sk,KV,D) → (B,Sq,H,D) in q.dtype.

    ``reference_attention`` with the kernel's empty-row rule: a query row
    that sees no key is 0 (the JAX oracle would average v over it).  The
    output is contiguous, as the kernel's is.  ``q_offset``: the absolute
    position of q's first row."""
    out = reference_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    seen = attention_mask(q.shape[1], k.shape[1], causal, window,
                          q.device, q_offset).any(dim=1)
    return (out * seen[None, :, None, None].to(out.dtype)).contiguous()


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Sq,H,D), k = v (B,Sk,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(
            f"head dim {D} not built; the kernel takes {HEAD_DIMS}: the bf16 "
            "route's wgmma k-steps are 16 wide, and no config's head dim is "
            "above 128")


def _tile_ready(t):
    """``t`` as the tensor-core route reads it: d contiguous, rows 16-byte
    aligned (pointer at 16 bytes, every other stride a multiple of 8
    elements: a TMA tensor map's terms).  Any BSHD view that is not is
    copied first."""
    ok = t.data_ptr() % 16 == 0 and t.stride(-1) == 1 and all(
        st % 8 == 0 for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1)
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _strides(t):
    """(b, s, h, d) strides, 0 for a dim of size 1 (read at index 0 only)."""
    return tuple(0 if n == 1 else st for n, st in zip(t.shape, t.stride()))


@functools.cache
def _library():
    """The kernel's library, built and bound on first use."""
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_encode_ns.restype = ctypes.c_longlong
    lib.flash_attention_encode_ns.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 7)
    return lib


def encode_us(q, k, v, iters: int = 1000) -> float:
    """Host µs that one bf16 launch spends encoding its three TMA tensor
    maps (q, k, v as the kernel would read them), the mean of ``iters``;
    no device work."""
    _check(q, k, v)
    q, k, v = _tile_ready(q), _tile_ready(k), _tile_ready(v)
    B, Sq, H, D = q.shape
    strides = (ctypes.c_longlong * 12)(*_strides(q), *_strides(k), *_strides(v))
    ns = _library().flash_attention_encode_ns(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, B, Sq, k.shape[1],
        H, k.shape[2], D, iters)
    if ns < 0:
        raise RuntimeError("flash attention: a tensor map did not encode")
    return ns / iters / 1e3


def flash_attention_cuda(q, k, v, *, causal=True, window=None, q_offset=0):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.

    Reads q/k/v through their strides (any BSHD view; for bf16 a view
    whose rows are not 16-byte aligned is copied first); allocates only the
    output.  Raises on what the kernel does not take and when the launch
    is refused.

    The kernel is forward only, so its output carries no autograd history.
    With grad mode on and an input that requires grad it raises rather
    than drop the gradient through attention."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash attention kernel has no backward (the TPU kernel it "
            "replaces, flash_attention_pallas, has none either); train with "
            "use_flash_attention=False, or run under torch.no_grad().  A "
            "backward is a later slice (ROADMAP.md queue 2, step item 2)")
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if Sq == 0:
        return out
    if Sk == 0:
        return out.zero_()
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if window is not None:
        # any window ≥ q_offset + Sq already sees every key from 0: clamp
        # to C int range
        window = min(int(window), q_offset + Sq)
    if route(q.dtype) == "tensor_cores":
        q, k, v = _tile_ready(q), _tile_ready(k), _tile_ready(v)
    fn = _library().flash_attention_fwd
    strides = (ctypes.c_longlong * 16)(
        *_strides(q), *_strides(k), *_strides(v), *_strides(out))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, _DTYPE_CODES[q.dtype], B, Sq, Sk, H, KV, D,
                 q_offset, int(causal), int(window is not None), window or 0,
                 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out
