"""Public entry points of the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  The route follows the tensor's
device and nothing else: a CPU tensor takes the plain PyTorch version, a
CUDA tensor launches the kernel or the call raises.  There is no switch
that runs the plain version on the card and no fallback after a failed
launch.

The update entry points work in place and take their scalars as a small
f32 tensor (``async_update.sgd_scalars`` / ``momentum_scalars`` /
``adam_scalars``).  The JAX ``ssd_chunk`` wrapper takes a ``use_kernel``
argument that it ignores; this one has none: the model's ``use_ssd_kernel``
decides whether :func:`ssd_chunk` is called at all.
"""
from __future__ import annotations

from . import async_update as _au
from . import flash_attention as _fa
from . import ssd_chunk as _ssd


def _route(name, t):
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise RuntimeError(f"{name} has no kernel for device {t.device}")


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (B,Sq,H,D); k/v: (B,Sk,KV,D) with H % KV == 0 → (B,Sq,H,D)."""
    if _route("flash attention", q) == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)


def async_update(p, gbuf, g, scal):
    """p −= eff·gbuf; gbuf ← g.  Returns (p, gbuf)."""
    if _route("async_update", p) == "cpu":
        return _au.async_update_plain(p, gbuf, g, scal)
    return _au.async_update_cuda(p, gbuf, g, scal)


def sgd_step(p, g, scal):
    """p −= eff·g.  Returns p."""
    if _route("sgd_step", p) == "cpu":
        return _au.sgd_step_plain(p, g, scal)
    return _au.sgd_step_cuda(p, g, scal)


def sgd_momentum_step(p, m, g, scal, *, momentum):
    """m′ = μ·m + clip·g; p −= lr_eff·m′.  Returns (p, m)."""
    if _route("sgd_momentum_step", p) == "cpu":
        return _au.sgd_momentum_step_plain(p, m, g, scal, momentum=momentum)
    return _au.sgd_momentum_step_cuda(p, m, g, scal, momentum=momentum)


def sgd_momentum_delayed(p, m, gbuf, g, scal, *, momentum):
    """The heavy-ball step on gbuf, then gbuf ← g.  Returns (p, m, gbuf)."""
    if _route("sgd_momentum_delayed", p) == "cpu":
        return _au.sgd_momentum_delayed_plain(p, m, gbuf, g, scal,
                                              momentum=momentum)
    return _au.sgd_momentum_delayed_cuda(p, m, gbuf, g, scal,
                                         momentum=momentum)


def fused_adam(p, m, v, g, scal, *, beta1=0.9, beta2=0.95, eps=1e-8):
    """One Adam step on clip·g.  Returns (p, m, v)."""
    kw = dict(beta1=beta1, beta2=beta2, eps=eps)
    if _route("fused_adam", p) == "cpu":
        return _au.fused_adam_plain(p, m, v, g, scal, **kw)
    return _au.fused_adam_cuda(p, m, v, g, scal, **kw)


def fused_adam_delayed(p, m, v, gbuf, g, scal, *, beta1=0.9, beta2=0.95,
                       eps=1e-8):
    """One Adam step on clip·gbuf, then gbuf ← g.  Returns (p, m, v, gbuf)."""
    kw = dict(beta1=beta1, beta2=beta2, eps=eps)
    if _route("fused_adam_delayed", p) == "cpu":
        return _au.fused_adam_delayed_plain(p, m, v, gbuf, g, scal, **kw)
    return _au.fused_adam_delayed_cuda(p, m, v, gbuf, g, scal, **kw)


def ssd_chunk(x, dt, A, B_, C_):
    """Intra-chunk SSD.  x: (B,nc,c,H,P); dt: (B,nc,c,H) f32; A: (H,) f32;
    B_/C_: (B,nc,c,N) → (y (B,nc,c,H,P) in x.dtype, states (B,nc,H,N,P)
    f32)."""
    if _route("ssd_chunk", x) == "cpu":
        return _ssd.ssd_chunk_plain(x, dt, A, B_, C_)
    return _ssd.ssd_chunk_cuda(x, dt, A, B_, C_)
