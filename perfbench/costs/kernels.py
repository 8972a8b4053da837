"""The work one call of each hand-written kernel must do, from its shapes.

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again; operations are the products the
algorithm needs on the (query, key) pairs the masks leave visible.
"""
from __future__ import annotations

import numpy as np


def visible_pairs(Sq: int, Sk: int, causal: bool, window=None,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the masks leave visible: keys from 0, query row
    r at ``q_offset + r`` (causal ``kp <= qp``, window ``kp > qp −
    window``)."""
    qp = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qp, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window is not None else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_cost(B: int, Sq: int, Sk: int, H: int, KV: int, D: int,
               elem: int = 2, causal: bool = True) -> tuple:
    """(flops, bytes) of one flash attention call on q (B, Sq, H, D) and
    k / v (B, Sk, KV, D): 2·D multiply-adds for QKᵀ and for PV on every
    visible pair; q, k, v read once, the output written once."""
    flops = 4 * D * visible_pairs(Sq, Sk, causal) * B * H
    return flops, 2 * (B * Sq * H * D + B * Sk * KV * D) * elem


def ssd_cost(B: int, nc: int, c: int, H: int, P: int, N: int,
             x_elem: int = 2, bc_elem: int = 2) -> tuple:
    """(flops, bytes) of one SSD chunk call on x (B, nc, c, H, P) and B / C
    (B, nc, c, N): 2·c·c·N (C Bᵀ) + 2·c·c·P (scores · x·dt) + 2·c·N·P (the
    state) per (batch·chunk, head) cell; x, dt (f32), A (f32), B, C read
    once, y and the f32 states written once."""
    cells = B * nc * H
    nbytes = (2 * cells * c * P * x_elem + B * nc * c * H * 4 + H * 4
              + 2 * B * nc * c * N * bc_elem + cells * N * P * 4)
    return 2 * cells * (c * c * N + c * c * P + c * N * P), nbytes


#: f32 moments each update kernel reads and writes
_MOMENTS = {"async_update": 0, "sgd_step": 0, "sgd_momentum_step": 1,
            "sgd_momentum_delayed": 1, "fused_adam": 2,
            "fused_adam_delayed": 2}
#: the kernels that swap the delayed buffer (read it, write the fresh grad)
_SWAPS = ("async_update", "sgd_momentum_delayed", "fused_adam_delayed")


def update_bytes_per_elem(name: str, p_size: int, g_size: int) -> int:
    """Bytes one element moves through update kernel ``name`` with params
    of ``p_size`` and grads of ``g_size`` bytes: p read and written, each
    f32 moment read and written, the buffer read and written (the kernels
    that swap it), g read."""
    buf = 2 * g_size if name in _SWAPS else 0
    return 2 * p_size + 8 * _MOMENTS[name] + buf + g_size
