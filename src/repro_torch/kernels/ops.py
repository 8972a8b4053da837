"""Public entry points of the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  The route follows the tensor's
device and nothing else: a CPU tensor takes the plain PyTorch version, a
CUDA tensor launches the kernel or the call raises.  There is no switch
that runs the plain version on the card and no fallback after a failed
launch.
"""
from __future__ import annotations

from . import flash_attention as _fa


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (B,Sq,H,D); k/v: (B,Sk,KV,D) with H % KV == 0 → (B,Sq,H,D)."""
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    raise RuntimeError(f"flash attention has no kernel for device {q.device}")
