"""Plain PyTorch oracles for the port's kernels.

Counterpart of ``repro/kernels/ref.py``: the attention oracle, the
server-update oracles (eq. 2 as SGD on the stale buffer, Adam and
heavy-ball SGD, each also on the stale buffer) and the sequential SSD
recurrence that the chunked SSD kernel is held to.

The update oracles are functional and follow the JAX oracles op for op,
including where they differ from the kernels: ``reference_fused_adam``
casts the STEP to the param dtype before subtracting, where the kernel
subtracts in f32 and casts once, so the two agree only to bf16 tolerance
on bf16 params.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
NEG_INF = -1e30


def attention_mask(Sq: int, Sk: int, causal: bool, window, device=None,
                   q_offset: int = 0):
    """(Sq, Sk) bool: key position kp is visible from query position qp.

    Key positions count from 0, query row r is at ``q_offset + r`` (0: no
    ``Sk − Sq`` offset): causal is ``kp <= qp``, the window keeps ``kp >
    qp − window``."""
    qp = torch.arange(Sq, device=device)[:, None] + q_offset
    kp = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return ok


def reference_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """Naive softmax attention.  q: (B,Sq,H,D); k/v: (B,Sk,KV,D); q's
    first row at absolute position ``q_offset``.

    A row with no visible key averages v over every key, as the JAX oracle
    does (its mask bias is finite)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, D).to(F32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.to(F32)) / math.sqrt(D)
    ok = attention_mask(Sq, Sk, causal, window, q.device, q_offset)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(F32))
    return o.reshape(B, Sq, H, D).to(q.dtype)


def reference_async_update(params, gbuf, grads, *, lr, clip_scale, delay_scale):
    """Server update (eq. 2), fused semantics:
        p'    = p − lr·delay_scale·clip_scale·gbuf   (apply the STALE grad)
        gbuf' = grads                                (buffer the fresh grad)
    All flat f32/bf16 tensors of identical shape."""
    eff = lr * delay_scale * clip_scale
    p_new = (params.to(F32) - eff * gbuf.to(F32)).to(params.dtype)
    return p_new, grads


def reference_fused_adam(p, m, v, g, *, lr, beta1, beta2, eps, bc1, bc2,
                         clip_scale=1.0, weight_decay=0.0):
    """One fused Adam step on flat tensors; moments f32."""
    g32 = clip_scale * g.to(F32)
    m_new = beta1 * m + (1 - beta1) * g32
    v_new = beta2 * v + (1 - beta2) * g32 * g32
    step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    step = step + weight_decay * p.to(F32)
    p_new = p - (lr * step).to(p.dtype)
    return p_new, m_new, v_new


def reference_fused_adam_delayed(p, m, v, gbuf, g, *, lr, beta1, beta2, eps,
                                 bc1, bc2, clip_scale=1.0, weight_decay=0.0):
    """Delayed-buffer Adam: the stale gbuf drives the step, the fresh g is
    buffered.  Returns (p', m', v', gbuf')."""
    p_new, m_new, v_new = reference_fused_adam(
        p, m, v, gbuf, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
        bc1=bc1, bc2=bc2, clip_scale=clip_scale, weight_decay=weight_decay)
    return p_new, m_new, v_new, g


def reference_sgd_momentum(p, m, g, *, lr, momentum, clip_scale=1.0,
                           delay_scale=1.0):
    """Fused heavy-ball step on flat tensors; m f32.  Returns (p', m')."""
    m_new = momentum * m + clip_scale * g.to(F32)
    p_new = (p.to(F32) - (lr * delay_scale) * m_new).to(p.dtype)
    return p_new, m_new


def reference_sgd_momentum_delayed(p, m, gbuf, g, *, lr, momentum,
                                   clip_scale=1.0, delay_scale=1.0):
    """Delayed-buffer heavy-ball: the stale gbuf drives the step, the fresh
    g is buffered.  Returns (p', m', gbuf')."""
    p_new, m_new = reference_sgd_momentum(
        p, m, gbuf, lr=lr, momentum=momentum, clip_scale=clip_scale,
        delay_scale=delay_scale)
    return p_new, m_new, g


def reference_ssd_chunk(x, dt, A, B_, C_):
    """Single-chunk SSD (sequential recurrence oracle).

    x: (c, H, P); dt: (c, H); A: (H,); B_/C_: (c, N).
    Returns (y (c,H,P) in x's dtype, h_final (H,P,N) f32) with h0 = 0.
    """
    c, H, P = x.shape
    N = B_.shape[-1]
    h = torch.zeros((H, P, N), dtype=F32, device=x.device)
    ys = []
    for t in range(c):
        a = torch.exp(dt[t].to(F32) * A.to(F32))                    # (H,)
        upd = torch.einsum("hp,n->hpn", (x[t] * dt[t][:, None]).to(F32),
                           B_[t].to(F32))
        h = h * a[:, None, None] + upd
        ys.append(torch.einsum("hpn,n->hp", h, C_[t].to(F32)))
    return torch.stack(ys).to(x.dtype), h
