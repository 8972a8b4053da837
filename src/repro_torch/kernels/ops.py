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

A ``meta`` tensor (the dry-run's trace, ``launch/dryrun.py``) takes the
plain version too: there it allocates nothing and computes nothing.  Under
an active cost tally (``launch/op_cost.py``) each call counts as one kernel
launch with the kernel's own formula, whatever route it takes.
"""
from __future__ import annotations

from ..launch import op_cost as _cost
from . import async_update as _au
from . import flash_attention as _fa
from . import ssd_chunk as _ssd


def _route(name, t):
    """"cuda" (the kernel) for a CUDA tensor, "plain" (its plain version)
    for a CPU or meta tensor; any other device raises."""
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type in ("cpu", "meta"):
        return "plain"
    raise RuntimeError(f"{name} has no kernel for device {t.device}")


def _launch(name, *args, **kw):
    """Kernel ``name`` (``<name>_cuda`` or ``<name>_plain`` of its module) on
    the route of ``args[0]``'s device; an active cost tally counts the call
    as one launch of ``name`` (``op_cost.kernel_cost``)."""
    mod = {"flash_attention": _fa, "ssd_chunk": _ssd}.get(name, _au)
    fn = getattr(mod, f"{name}_{_route(name, args[0])}")
    return _cost.counted(name, fn, *args, **kw)


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """q: (B,Sq,H,D); k/v: (B,Sk,KV,D) with H % KV == 0 → (B,Sq,H,D).
    ``q_offset``: the absolute position of q's first row (a block of the
    rows whose k / v are whole); at 0 the call is the plain one."""
    # passed on only when set: a call at 0 is the same call as before the
    # argument existed, to the kernel and to anything that wraps it
    kw = {"q_offset": q_offset} if q_offset else {}
    return _launch("flash_attention", q, k, v, causal=causal, window=window,
                   **kw)


def async_update(p, gbuf, g, scal):
    """p −= eff·gbuf; gbuf ← g.  Returns (p, gbuf)."""
    return _launch("async_update", p, gbuf, g, scal)


def sgd_step(p, g, scal):
    """p −= eff·g.  Returns p."""
    return _launch("sgd_step", p, g, scal)


def sgd_momentum_step(p, m, g, scal, *, momentum):
    """m′ = μ·m + clip·g; p −= lr_eff·m′.  Returns (p, m)."""
    return _launch("sgd_momentum_step", p, m, g, scal, momentum=momentum)


def sgd_momentum_delayed(p, m, gbuf, g, scal, *, momentum):
    """The heavy-ball step on gbuf, then gbuf ← g.  Returns (p, m, gbuf)."""
    return _launch("sgd_momentum_delayed", p, m, gbuf, g, scal,
                   momentum=momentum)


def fused_adam(p, m, v, g, scal, *, beta1=0.9, beta2=0.95, eps=1e-8):
    """One Adam step on clip·g.  Returns (p, m, v)."""
    return _launch("fused_adam", p, m, v, g, scal, beta1=beta1, beta2=beta2,
                   eps=eps)


def fused_adam_delayed(p, m, v, gbuf, g, scal, *, beta1=0.9, beta2=0.95,
                       eps=1e-8):
    """One Adam step on clip·gbuf, then gbuf ← g.  Returns (p, m, v, gbuf)."""
    return _launch("fused_adam_delayed", p, m, v, gbuf, g, scal, beta1=beta1,
                   beta2=beta2, eps=eps)


def ssd_chunk(x, dt, A, B_, C_):
    """Intra-chunk SSD.  x: (B,nc,c,H,P); dt: (B,nc,c,H) f32; A: (H,) f32;
    B_/C_: (B,nc,c,N) → (y (B,nc,c,H,P) in x.dtype, states (B,nc,H,N,P)
    f32)."""
    return _launch("ssd_chunk", x, dt, A, B_, C_)
