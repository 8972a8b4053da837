"""Plain PyTorch oracles for the port's kernels.

Counterpart of ``repro/kernels/ref.py``; this slice carries the attention
oracle.  The update and SSD oracles arrive with their kernels.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
NEG_INF = -1e30


def attention_mask(Sq: int, Sk: int, causal: bool, window, device=None):
    """(Sq, Sk) bool: key position kp is visible from query position qp.

    Both positions count from 0: causal is ``kp <= qp`` (no ``Sk − Sq``
    offset), the window keeps ``kp > qp − window``."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return ok


def reference_attention(q, k, v, *, causal=True, window=None):
    """Naive softmax attention.  q: (B,Sq,H,D); k/v: (B,Sk,KV,D).

    A row with no visible key averages v over every key, as the JAX oracle
    does (its mask bias is finite)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, D).to(F32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.to(F32)) / math.sqrt(D)
    ok = attention_mask(Sq, Sk, causal, window, q.device)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(F32))
    return o.reshape(B, Sq, H, D).to(q.dtype)
