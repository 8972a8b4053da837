"""Model building blocks of the dense and SSM families, plain PyTorch.

Counterpart of ``repro/models/layers.py`` (norm, RoPE, GQA attention,
one-token decode attention, SwiGLU, Mamba2's chunked SSD scan and its
one-token step, the depthwise causal conv, the token cross entropy).
Activations follow the JAX package's dtype rules:

* JAX promotes mixed operands (bf16 params × f32 activations → f32); torch
  refuses mixed-dtype products, so :func:`einsum` casts every operand to
  the promoted type first.
* Where JAX keeps bf16 operands with f32 accumulation
  (``preferred_element_type``), the port upcasts the operands to f32, which
  is exact for bf16 values, and casts the result where JAX casts it.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops

F32 = torch.float32
NEG_INF = -1e30


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's type promotion across the operands."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dt) for o in ops))


# ---------------------------------------------------------------------------
# normalisation / embeddings
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-5):
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.to(F32)).to(x.dtype)


def rope(x, positions, theta: float = 1e4):
    """Rotary embeddings on split halves.  x: (..., S, H, D); positions:
    (S,) or (..., S), any integer or float tensor."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=F32,
                                          device=x.device) / half))
    ang = positions.to(F32)[..., None] * freqs             # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(Sq, Sk) additive f32 bias from causal + sliding-window constraints."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG_INF).to(F32)


def _sdpa(q, k, v, bias):
    """q: (B,Sq,H,D), k/v: (B,Sk,KV,D), bias: (Sq,Sk).

    Scores and the probability-weighted sum accumulate in f32; the probs are
    cast to v's dtype before the second product, as in the JAX package."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qr.to(F32), k.to(F32))
    scores = scores / math.sqrt(D)
    scores = scores + bias[None, None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).to(F32),
                       v.to(F32))
    return out.reshape(B, Sq, H, D).to(v.dtype)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, chunk_q: int = 512, dense_max: int = 1024):
    """Self/cross attention with GQA.  Chunked over query blocks when long,
    by the same rule as the JAX package."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    if max(Sq, Sk) <= dense_max or Sq < 2 * chunk_q:
        return _sdpa(q, k, v, _mask_bias(q_pos, k_pos, causal, window))

    n_chunks = Sq // chunk_q
    outs = [_sdpa(q[:, i * chunk_q:(i + 1) * chunk_q], k, v,
                  _mask_bias(q_pos[i * chunk_q:(i + 1) * chunk_q], k_pos,
                             causal, window))
            for i in range(n_chunks)]
    rem = Sq - n_chunks * chunk_q
    if rem:
        outs.append(_sdpa(q[:, -rem:], k, v,
                          _mask_bias(q_pos[-rem:], k_pos, causal, window)))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cache_positions, pos,
                     window: Optional[int] = None):
    """One-token attention against a ring-buffer cache.

    q: (B,1,H,D); caches: (B,W,KV,D); cache_positions: (W,) int32 holding the
    absolute position stored in each slot (−1 = empty); pos: the current
    token's position.  The current token's own k/v must already be written.

    Ragged (slot-server) variant: ``pos`` is a (B,) tensor and
    ``cache_positions`` is (B, W): each row decodes at its own position, so
    the validity mask is per row.  The lock-step op sequence is unchanged.
    """
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        p = pos[:, None]
        valid = (cache_positions >= 0) & (cache_positions <= p)
        if window is not None:
            valid &= cache_positions > p - window
        # (B,1,1,1,W): broadcasts over the (B,KV,G,Sq,W) scores
        bias = torch.where(valid, 0.0, NEG_INF).to(F32)[:, None, None, None]
    else:
        valid = (cache_positions >= 0) & (cache_positions <= pos)
        if window is not None:
            valid &= cache_positions > pos - window
        bias = torch.where(valid, 0.0, NEG_INF).to(F32)    # (W,)

    B, Sq, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qr.to(F32),
                          k_cache.to(F32)) / math.sqrt(D)
    scores = scores + bias
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    probs = (p / l).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(F32), v_cache.to(F32))
    return out.reshape(B, Sq, H, D).to(v_cache.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    g = einsum("bsd,df->bsf", x, w_gate)
    u = einsum("bsd,df->bsf", x, w_up)
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return einsum("bsf,fd->bsd", h, w_down)


# ---------------------------------------------------------------------------
# Mamba2 (state-space duality, chunked)
# ---------------------------------------------------------------------------

def _segsum(a):
    """a: (..., C).  Returns (..., C, C) with out[i,j] = Σ_{k=j+1..i} a_k for
    j < i, 0 on the diagonal, −inf above (the 1-semiseparable log-decay
    matrix)."""
    C = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((C, C), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B_, C_, chunk: int = 128, h0=None,
                use_kernel: bool = False):
    """Chunked SSD scan (Mamba2, alg. of Dao & Gu 2024 §6).

    x:  (B, S, H, P)  — per-head inputs
    dt: (B, S, H)     — post-softplus step sizes
    A:  (H,)          — negative decay rates (A = −exp(A_log))
    B_: (B, S, N), C_: (B, S, N)  — shared across heads (n_groups=1)
    h0: optional initial state (B, H, P, N)
    Returns (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) f32).

    ``use_kernel`` takes the intra-chunk part through ``ops.ssd_chunk`` (the
    CUDA kernel on the card, its plain version on the CPU), whose y lands in
    x's dtype before the inter-chunk term is added, as in the JAX package;
    otherwise it is the einsum branch, f32 throughout.  The inter-chunk
    recurrence is a loop over the chunks.
    """
    Bb, S, H, P = x.shape
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"sequence length {S} must be a multiple of the "
                         f"chunk {chunk}")
    la = dt.to(F32) * A[None, None, :].to(F32)                 # (B,S,H)

    def r(t):  # split the sequence axis into (nc, chunk)
        return t.reshape(t.shape[0], nc, chunk, *t.shape[2:])

    xc, dtc, lac = r(x), r(dt), r(la)                          # lac: (B,k,c,H)
    Bc, Cc = r(B_).to(F32), r(C_).to(F32)                      # (B,k,c,N)
    xdt = (xc * dtc[..., None]).to(F32)                        # (B,k,c,H,P)
    cums = torch.cumsum(lac, dim=2)                            # (B,k,c,H)

    if use_kernel:
        y_diag, st = ops.ssd_chunk(xc, dtc, A, r(B_), r(C_))
        y_diag = y_diag.to(F32)
        states = st.transpose(-1, -2)                          # (B,k,H,P,N)
    else:
        # letters: b batch, k chunk, i/j pos-in-chunk, h head, p P, n N
        Lh = torch.exp(_segsum(lac.movedim(-1, 2)))            # (B,k,H,i,j)
        scores = torch.einsum("bkin,bkjn->bkij", Cc, Bc)       # CBᵀ, head-shared
        y_diag = torch.einsum("bkij,bkhij,bkjhp->bkihp", scores, Lh, xdt)
        decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)    # (B,k,c,H)
        states = torch.einsum("bkjn,bkjhp->bkhpn", Bc,
                              xdt * decay_to_end[..., None])   # (B,k,H,P,N)

    # inter-chunk recurrence over k: h_prev[k] is the state entering chunk k
    chunk_decay = torch.exp(cums[:, :, -1, :])                 # (B,k,H)
    h = (torch.zeros((Bb, H, P, B_.shape[-1]), dtype=F32, device=x.device)
         if h0 is None else h0.to(F32))
    h_prev = []
    for k in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, k, :, None, None] + states[:, k]
    h_prev = torch.stack(h_prev, dim=1)                        # (B,k,H,P,N)

    decay_from_start = torch.exp(cums)                         # (B,k,c,H)
    y_off = torch.einsum("bkin,bkhpn,bkih->bkihp", Cc, h_prev,
                         decay_from_start)
    y = (y_diag + y_off).reshape(Bb, S, H, P)
    return y.to(x.dtype), h


def ssd_decode_step(h, x_t, dt_t, A, B_t, C_t):
    """One-token SSD update.  h: (B,H,P,N); x_t: (B,H,P); dt_t: (B,H);
    B_t/C_t: (B,N).  Returns (y (B,H,P), h_new)."""
    a = torch.exp((dt_t * A[None, :]).to(F32))                 # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", (x_t * dt_t[..., None]).to(F32),
                       B_t.to(F32))
    h_new = h * a[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, C_t.to(F32))
    return y.to(x_t.dtype), h_new


# ---------------------------------------------------------------------------
# depthwise causal conv1d (mamba front conv)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, b=None):
    """x: (B,S,D); w: (K,D) depthwise kernel; left-padded causal.

    The K shifted products are summed in x's dtype, as the JAX package
    sums them (not ``F.conv1d``, which runs float32 through cuDNN's TF32
    by default and accumulates bf16 otherwise)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    if b is not None:
        out = out + b[None, None, :]
    return F.silu(out.to(F32)).to(x.dtype)


def conv1d_decode(conv_state, x_t, w, b=None):
    """conv_state: (B,K−1,D) past inputs; x_t: (B,D).  Returns (y,
    new_state)."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # (B,K,D)
    y = einsum("bkd,kd->bd", full, w)
    if b is not None:
        y = y + b[None, :]
    new_state = full[:, 1:, :]
    return F.silu(y.to(F32)).to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits, labels, mask=None):
    """Token-level cross entropy, f32 accumulation.  logits (..., V)."""
    logits = logits.to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if mask is not None:
        return torch.sum(nll * mask) / (torch.sum(mask) + 1e-6)
    return torch.mean(nll)
