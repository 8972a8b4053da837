"""Fused server-update kernels: the CUDA wrappers and their plain versions.

Counterpart of ``repro/kernels/async_update.py``: all six of its kernels.
The kernels themselves are
``csrc/async_update.cu`` (CUDA C++ for ``sm_90a``), built at first use by
``kernels/_build.py`` and called through ``ctypes``.

========================  =============================  ===============================
kernel                    computes                       replaces (TPU)
========================  =============================  ===============================
``async_update``          p −= eff·gbuf; gbuf ← g        ``async_update_pallas``
``sgd_step``              p −= eff·g                     ``sgd_step_pallas``
``sgd_momentum_step``     m′ = μm + clip·g; p −= lr·m′   ``sgd_momentum_step_pallas``
``sgd_momentum_delayed``  the same on gbuf; gbuf ← g     ``sgd_momentum_delayed_pallas``
``fused_adam``            Adam on clip·g                 ``fused_adam_pallas``
``fused_adam_delayed``    Adam on clip·gbuf; gbuf ← g    ``fused_adam_delayed_pallas``
========================  =============================  ===============================

Every function here updates its operands IN PLACE (the JAX step donates
them) and returns the same tensors: p keeps its dtype, gbuf′ takes g's
dtype (so gbuf and g share one), m and v are f32.  The scalars arrive as a
small f32 tensor on the operands' device, ``[eff, run]`` for the SGD
kernels, ``[lr·delay_scale, clip, run]`` for the heavy-ball kernels and
``[lr, bc1, bc2, clip, wd, run]`` for the Adam kernels
(:func:`sgd_scalars`, :func:`momentum_scalars`, :func:`adam_scalars`), as
the TPU kernels take them from an SMEM block.  They may be device values
(clip scale, bias corrections, gate), and nothing here reads them back to
the host.  The momentum μ, like β1, is a launch argument.

``run`` is the guard rails' skip gate (``AsyncConfig.guards``), a device
value 1 or 0 taken from the round's finite check.  At 0 a call writes
nothing: p, m, v and gbuf keep their bits, whatever g holds (NaN
included), and the stale gbuf is not replaced by g — what the JAX step's
skip branch keeps.  At 1 (the default, and always without guards) every
call computes what it computed before the gate existed.

* ``<name>_cuda`` launches the kernel on a CUDA tensor and adds one to
  ``launches[name]`` per launch; it raises on what the kernel does not take
  and when the launch is refused.
* ``<name>_plain`` is the Pallas body step by step in plain PyTorch (f32
  arithmetic, one cast at the end): the CPU path, and the yardstick the
  kernel is held to on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

F32 = torch.float32
KERNELS = ("async_update", "sgd_step", "sgd_momentum_step",
           "sgd_momentum_delayed", "fused_adam", "fused_adam_delayed")

#: kernel launches since the counters were last set, by kernel name; the
#: main path's proof that the update went through the kernels
launches = dict.fromkeys(KERNELS, 0)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


# ---------------------------------------------------------------------------
# scalar blocks
# ---------------------------------------------------------------------------

def _f32(x, device):
    return torch.as_tensor(x, dtype=F32, device=device).reshape(())


def sgd_scalars(lr, clip_scale, delay_scale, device, run=1.0):
    """``[eff, run]`` with eff = (lr·clip_scale)·delay_scale, the JAX
    order."""
    eff = (lr * _f32(clip_scale, device)) * _f32(delay_scale, device)
    return torch.stack([eff, _f32(run, device)])


def momentum_scalars(lr, clip_scale, delay_scale, device, run=1.0):
    """``[lr·delay_scale, clip, run]``, as the JAX heavy-ball wrappers
    stack the first two."""
    return torch.stack([lr * _f32(delay_scale, device),
                        _f32(clip_scale, device), _f32(run, device)])


def adam_bias_corrections(beta1, beta2, count):
    """(bc1, bc2) in f32 from the (device) step count, as the JAX kernel
    wrapper computes them."""
    c = count.to(F32)
    return 1.0 - torch.pow(beta1, c), 1.0 - torch.pow(beta2, c)


def adam_scalars(lr, bc1, bc2, clip_scale, weight_decay, device, run=1.0):
    """``[lr, bc1, bc2, clip, wd, run]`` as one f32 tensor on ``device``."""
    return torch.stack([_f32(x, device) for x in
                        (lr, bc1, bc2, clip_scale, weight_decay, run)])


def _adam_coefs(beta1, beta2, eps):
    """(b1, 1 − b1, b2, 1 − b2, eps): the differences taken in double and
    rounded once to f32, as the Pallas body's weak-typed constants are."""
    return (ctypes.c_float(beta1), ctypes.c_float(1.0 - beta1),
            ctypes.c_float(beta2), ctypes.c_float(1.0 - beta2),
            ctypes.c_float(eps))


# ---------------------------------------------------------------------------
# plain versions (the Pallas bodies, in place)
# ---------------------------------------------------------------------------

def _put(run, dst, new):
    """dst ← new where the run flag is set, else dst's own bits (a select,
    so the flag stays on the device)."""
    dst.copy_(torch.where(run, new.to(dst.dtype), dst))


def async_update_plain(p, gbuf, g, scal):
    eff, run = scal[0], scal[1] != 0
    stale = gbuf.to(F32)
    _put(run, p, p.to(F32) - eff * stale)
    _put(run, gbuf, g)
    return p, gbuf


def sgd_step_plain(p, g, scal):
    _put(scal[1] != 0, p, p.to(F32) - scal[0] * g.to(F32))
    return p


def sgd_momentum_step_plain(p, m, g, scal, *, momentum):
    lr_eff, clip, run = scal.unbind()
    run = run != 0
    m_new = momentum * m + clip * g.to(F32)
    _put(run, p, p.to(F32) - lr_eff * m_new)
    _put(run, m, m_new)
    return p, m


def sgd_momentum_delayed_plain(p, m, gbuf, g, scal, *, momentum):
    sgd_momentum_step_plain(p, m, gbuf, scal, momentum=momentum)  # gbuf first
    _put(scal[2] != 0, gbuf, g)
    return p, m, gbuf


def _adam_plain(p, m, v, graw, scal, beta1, beta2, eps):
    lr, bc1, bc2, clip, wd, run = scal.unbind()
    run = run != 0
    s = clip * graw.to(F32)
    m_new = beta1 * m + (1.0 - beta1) * s
    v_new = beta2 * v + (1.0 - beta2) * s * s
    step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    step = step + wd * p.to(F32)
    _put(run, p, p.to(F32) - lr * step)
    _put(run, m, m_new)
    _put(run, v, v_new)


def fused_adam_plain(p, m, v, g, scal, *, beta1=0.9, beta2=0.95, eps=1e-8):
    _adam_plain(p, m, v, g, scal, beta1, beta2, eps)
    return p, m, v


def fused_adam_delayed_plain(p, m, v, gbuf, g, scal, *, beta1=0.9,
                             beta2=0.95, eps=1e-8):
    _adam_plain(p, m, v, gbuf, scal, beta1, beta2, eps)   # reads gbuf first
    _put(scal[5] != 0, gbuf, g)
    return p, m, v, gbuf


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check(name, *, params, moments=(), grads, scal, n_scal):
    """Raise unless the operands are what the kernel takes."""
    ops = [params, *moments, *grads, scal]
    dev = params.device
    if dev.type != "cuda" or any(t.device != dev for t in ops):
        raise ValueError(f"{name}: every operand must lie on one CUDA device")
    if params.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: params must be float32 or bfloat16, got "
                        f"{params.dtype}")
    gdt = grads[0].dtype
    if gdt not in _DTYPE_CODES or any(t.dtype != gdt for t in grads):
        raise TypeError(f"{name}: gradient and buffer must share one float32 "
                        f"or bfloat16 dtype, got {[t.dtype for t in grads]}")
    if any(t.dtype != F32 for t in moments):
        raise TypeError(f"{name}: moments must be float32, got "
                        f"{[t.dtype for t in moments]}")
    if scal.dtype != F32 or scal.numel() != n_scal:
        raise TypeError(f"{name}: scalars must be {n_scal} float32 values, "
                        f"got {scal.numel()} {scal.dtype}")
    n = params.numel()
    if any(t.numel() != n for t in ops[:-1]):
        raise ValueError(f"{name}: operands differ in size: "
                         f"{[t.numel() for t in ops[:-1]]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{name}: operands must be contiguous")
    ptrs = [t.data_ptr() for t in ops]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError(f"{name}: operands must not share memory")


@functools.cache
def _lib():
    """The six C entry points, built and bound on first use."""
    lib = _build.load("async_update")
    P, I, L, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    sig = {
        "async_update": [P, P, P, P, L, I, I, P],
        "sgd_step": [P, P, P, L, I, I, P],
        "sgd_momentum_step": [P, P, P, P, L, I, I, Fl, P],
        "sgd_momentum_delayed": [P, P, P, P, P, L, I, I, Fl, P],
        "fused_adam": [P, P, P, P, P, L, I, I] + [Fl] * 5 + [P],
        "fused_adam_delayed": [P, P, P, P, P, P, L, I, I] + [Fl] * 5 + [P],
    }
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


def _launch(name, params, grads, *ptrs, coefs=()):
    n = params.numel()
    if n == 0:
        return
    fn = getattr(_lib(), name)
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, n, _DTYPE_CODES[params.dtype],
                 _DTYPE_CODES[grads.dtype], *coefs, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    launches[name] += 1


def async_update_cuda(p, gbuf, g, scal):
    _check("async_update", params=p, grads=(gbuf, g), scal=scal, n_scal=2)
    _launch("async_update", p, g, p.data_ptr(), gbuf.data_ptr(),
            g.data_ptr(), scal.data_ptr())
    return p, gbuf


def sgd_step_cuda(p, g, scal):
    _check("sgd_step", params=p, grads=(g,), scal=scal, n_scal=2)
    _launch("sgd_step", p, g, p.data_ptr(), g.data_ptr(), scal.data_ptr())
    return p


def sgd_momentum_step_cuda(p, m, g, scal, *, momentum):
    _check("sgd_momentum_step", params=p, moments=(m,), grads=(g,), scal=scal,
           n_scal=3)
    _launch("sgd_momentum_step", p, g, p.data_ptr(), m.data_ptr(),
            g.data_ptr(), scal.data_ptr(), coefs=(ctypes.c_float(momentum),))
    return p, m


def sgd_momentum_delayed_cuda(p, m, gbuf, g, scal, *, momentum):
    _check("sgd_momentum_delayed", params=p, moments=(m,), grads=(gbuf, g),
           scal=scal, n_scal=3)
    _launch("sgd_momentum_delayed", p, g, p.data_ptr(), m.data_ptr(),
            gbuf.data_ptr(), g.data_ptr(), scal.data_ptr(),
            coefs=(ctypes.c_float(momentum),))
    return p, m, gbuf


def fused_adam_cuda(p, m, v, g, scal, *, beta1=0.9, beta2=0.95, eps=1e-8):
    _check("fused_adam", params=p, moments=(m, v), grads=(g,), scal=scal,
           n_scal=6)
    _launch("fused_adam", p, g, p.data_ptr(), m.data_ptr(), v.data_ptr(),
            g.data_ptr(), scal.data_ptr(),
            coefs=_adam_coefs(beta1, beta2, eps))
    return p, m, v


def fused_adam_delayed_cuda(p, m, v, gbuf, g, scal, *, beta1=0.9,
                            beta2=0.95, eps=1e-8):
    _check("fused_adam_delayed", params=p, moments=(m, v), grads=(gbuf, g),
           scal=scal, n_scal=6)
    _launch("fused_adam_delayed", p, g, p.data_ptr(), m.data_ptr(),
            v.data_ptr(), gbuf.data_ptr(), g.data_ptr(), scal.data_ptr(),
            coefs=_adam_coefs(beta1, beta2, eps))
    return p, m, v, gbuf
