"""Model building blocks of the dense, SSM, hybrid and MoE families, plain
PyTorch.

Counterpart of ``repro/models/layers.py`` (norm, RoPE, GQA attention,
one-token decode attention, SwiGLU, the capacity-dispatched MoE, Mamba2's
chunked SSD scan and its one-token step, the depthwise causal conv, the
gated norm, the token cross entropy).  The Mamba2 parts run on whatever
heads and columns they are given: a rank of the model axis hands them its
own (``models/tp.py``), and the gated norm then sums its squares over the
ranks.
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


def gated_rms_norm(y, z, weight, eps: float = 1e-5, total=None,
                   width: Optional[int] = None):
    """Mamba2's gated norm: ``rms_norm(y · silu(z), weight)`` over the whole
    ``d_inner``, silu in f32 with one cast to y's dtype, as in the JAX
    package.  Split over ranks, ``y`` / ``z`` / ``weight`` are a rank's
    columns of ``width`` in all: the rank's Σ(y·silu(z))² in f32 is summed
    over the ranks by ``total`` (an all-reduce), then divided by
    ``width``.  Without ``total`` the whole width is here."""
    g = y * F.silu(z.to(F32)).to(y.dtype)
    if total is None:
        return rms_norm(g, weight, eps)
    g32 = g.to(F32)
    var = total(torch.sum(g32 * g32, dim=-1, keepdim=True)) / width
    return (g32 * torch.rsqrt(var + eps) * weight.to(F32)).to(g.dtype)


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


def _decode_bias(cache_positions, pos, window: Optional[int]):
    """The additive f32 bias of one token's attention over ring slots
    holding ``cache_positions`` (−1 = empty): (W,) at an int ``pos``
    (lock-step), (B, 1, 1, 1, W) at a (B,) ``pos`` against (B, W)
    positions (ragged), which broadcasts over the (B, KV, G, Sq, W)
    scores."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        p = pos[:, None]
        valid = (cache_positions >= 0) & (cache_positions <= p)
        if window is not None:
            valid &= cache_positions > p - window
        return torch.where(valid, 0.0, NEG_INF).to(F32)[:, None, None, None]
    valid = (cache_positions >= 0) & (cache_positions <= pos)
    if window is not None:
        valid &= cache_positions > pos - window
    return torch.where(valid, 0.0, NEG_INF).to(F32)


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
    bias = _decode_bias(cache_positions, pos, window)
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


def decode_attention_ctx(q, k_block, v_block, pos_block, pos,
                         window: Optional[int], amax, total):
    """:func:`decode_attention` (lock-step) on a rank's block of the ring's
    slots, the cache split over the model axis on ``ctx``: the rank's
    scores, their max over every rank (``amax``, an all-reduce of the
    max), Σ exp over every rank (``total``, an all-reduce of the sum),
    then the rank's share of the probability-weighted sum, which
    ``total`` sums.  q holds every head; the result too, on every rank.
    Ragged, as in :func:`decode_attention`: ``pos`` is a (B,) tensor and
    ``pos_block`` the rank's (B, W/M) block of the per-row buffer."""
    bias = _decode_bias(pos_block, pos, window)
    B, Sq, H, D = q.shape
    KV = k_block.shape[2]
    qr = q.reshape(B, Sq, KV, H // KV, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qr.to(F32),
                          k_block.to(F32)) / math.sqrt(D) + bias
    m = amax(torch.amax(scores, dim=-1, keepdim=True))
    p = torch.exp(scores - m)
    l = total(torch.sum(p, dim=-1, keepdim=True))
    probs = (p / l).to(v_block.dtype)
    out = total(torch.einsum("bkgqs,bskd->bqkgd", probs.to(F32),
                             v_block.to(F32)))
    return out.reshape(B, Sq, H, D).to(v_block.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    g = einsum("bsd,df->bsf", x, w_gate)
    u = einsum("bsd,df->bsf", x, w_up)
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return einsum("bsf,fd->bsd", h, w_down)


# ---------------------------------------------------------------------------
# Mixture of Experts (gather/scatter capacity dispatch)
# ---------------------------------------------------------------------------

def _top_k(x, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values and
    their indices, ties to the lower index.  A stable descending sort gives
    that order; ``torch.topk`` orders ties otherwise."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, w_router, top_k: int):
    """The router: (weights (T,k) f32, ids (T,k) int64, mean prob per
    expert (E,), share of tokens whose first expert is e (E,))."""
    logits = x.to(F32) @ w_router.to(F32)
    probs = torch.softmax(logits, dim=-1)
    w, ids = _top_k(probs, top_k)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-9)
    E = w_router.shape[-1]
    me = torch.mean(probs, dim=0)
    # the one-hot of each token's first expert, by a scatter: ``F.one_hot``
    # takes another op path on each device (a host read of the ids on the
    # CPU, a compare on ``meta``), which the dry-run's count must not see
    first = torch.zeros((ids.shape[0], E), dtype=F32, device=ids.device)
    fe = torch.mean(first.scatter_(1, ids[:, :1], 1.0), dim=0)
    return w, ids, me, fe


def moe_router(x, w_router, top_k: int):
    """Returns (weights (T,k) f32, ids (T,k) int64, aux load-balance loss):
    f32 router logits, softmax, the top k renormalised, and the Switch aux
    loss E · Σ_e (share of tokens whose first expert is e) · (mean prob e)."""
    w, ids, me, fe = _route(x, w_router, top_k)
    return w, ids, w_router.shape[-1] * torch.sum(me * fe)


def _dispatch(xt, weights, ids, w_gate, w_up, w_down, top_k, C, E=None,
              e0: int = 0):
    """One dispatch group: each expert takes its top C tokens of ``xt``
    (T, d) by routing weight, and the outputs combine in expert order.

    ``w_gate`` / ``w_up`` / ``w_down`` may hold a block of the ``E``
    experts, those from ``e0`` on (a rank's, under tensor parallelism):
    the routing is over all ``E``, each token's outputs from the block's
    experts are summed in ascending expert order, and the other experts'
    add nothing."""
    T, d = xt.shape
    El = w_gate.shape[0]
    E = El if E is None else E
    w_full = torch.zeros((T, E), dtype=F32, device=xt.device)
    w_full.scatter_(1, ids, weights)                           # (T, E)
    gate_w, token_idx = _top_k(w_full.t(), C)                   # (E, C)
    if El != E:
        gate_w, token_idx = gate_w[e0:e0 + El], token_idx[e0:e0 + El]
    x_e = xt[token_idx]                                        # (El, C, d)
    g = einsum("ecd,edf->ecf", x_e, w_gate)
    u = einsum("ecd,edf->ecf", x_e, w_up)
    h = F.silu(g.to(F32)).to(xt.dtype) * u
    y_e = einsum("ecf,efd->ecd", h, w_down)
    y_e = y_e * gate_w[..., None].to(y_e.dtype)
    # pick[e, t]: the c at which expert e took token t, or C (a zero row)
    pick = torch.full((El, T), C, dtype=torch.int64, device=xt.device)
    pick.scatter_(1, token_idx, torch.arange(
        C, device=xt.device).expand(El, C).contiguous())
    experts = torch.sort(ids, dim=-1).values                   # (T, k)
    y_pad = torch.cat([y_e, y_e.new_zeros((El, 1, d))], dim=1)
    if El == E:
        rows = experts * (C + 1) + torch.gather(pick.t(), 1, experts)
        parts = y_pad.reshape(E * (C + 1), d)[rows]            # (T, k, d)
    else:
        # another block's expert reads the zero row after the block's
        le = (experts - e0).clamp(0, El - 1)
        rows = le * (C + 1) + torch.gather(pick.t(), 1, le)
        rows = torch.where((experts >= e0) & (experts < e0 + El), rows,
                           El * (C + 1))
        parts = torch.cat([y_pad.reshape(El * (C + 1), d),
                           y_e.new_zeros((1, d))])[rows]
    y = torch.zeros((T, d), dtype=y_e.dtype, device=xt.device)
    for j in range(top_k):
        y = y + parts[:, j]
    return y


def moe_ffn(x, w_router, w_gate, w_up, w_down, top_k: int,
            capacity_factor: float = 1.25, *, first_expert: int = 0,
            enter=None):
    """Fine-grained top-k MoE over flattened tokens, as the JAX package's.

    x: (B,S,d); expert weights (E,d,f) / (E,f,d).  Each expert takes the
    top C tokens by routing weight, C = min(ceil(T·k/E·cf), T); a routed
    token beyond an expert's capacity is dropped there (its residual passes
    through).  Returns (y (B,S,d), aux).

    The combine is the JAX scatter-add without atomics: a token's ≤ k
    expert outputs are gathered through the inverse of the dispatch and
    summed in ascending expert order, the order of JAX's scatter updates,
    so the result is deterministic (a captured graph replays it bit for
    bit).  Tokens an expert picks at routing weight 0 add exactly 0 in
    JAX; they add nothing here.  Every shape follows from x's, so no value
    is read on the host.

    Under a data-parallel context (``distributed.sharding.data_context``,
    R ranks, each holding its rows of the batch) the dispatch is JAX's
    group-local one: JAX views the T tokens as G = R groups of T/R, and
    rank r's rows are group r, so each rank dispatches its own tokens with
    C from T/R.  The aux loss is over all T tokens: the first-expert
    shares are all-reduced (they carry no gradient), and the rank returns
    its share E · Σ_e (mean prob_e over its tokens / R) · (global share
    e), whose sum over the ranks is JAX's aux with JAX's gradient.  Where
    JAX falls back to one group (T/R < E), the ranks gather the layer's
    tokens (a differentiable all-gather whose backward reduce-scatters),
    each dispatches all T as one group, keeps its rows, and returns aux /
    R as its share.

    Expert parallelism (a rank of the model axis): the expert weights are
    the block of experts from ``first_expert`` on, the router is whole,
    and the routing, replicated, is over all its experts; ``enter`` (the
    copy-to-model operator) takes the tokens and the routing weights into
    the rank's experts.  y is then the rank's part of the combine, to be
    summed over the model ranks; aux is whole."""
    from ..distributed.sharding import data_context

    B, S, d = x.shape
    E = w_router.shape[-1]
    T = B * S
    enter = enter or (lambda t: t)
    experts = dict(E=E, e0=first_expert)
    ctx = data_context()
    if ctx is not None and ctx[1] > 1 and T < E:
        from ..distributed.collectives import all_gather_rows

        group, R, r = ctx
        xt = all_gather_rows(x.reshape(T, d), group)            # (R·T, d)
        weights, ids, aux = moe_router(xt, w_router, top_k)
        C = min(int(math.ceil(R * T * top_k / E * capacity_factor)), R * T)
        y = _dispatch(enter(xt), enter(weights), ids, w_gate, w_up, w_down,
                      top_k, C, **experts)
        return y[r * T:(r + 1) * T].reshape(B, S, d), aux / R
    xt = x.reshape(T, d)
    weights, ids, me, fe = _route(xt, w_router, top_k)
    if ctx is None:
        aux = E * torch.sum(me * fe)
    else:
        from ..distributed.collectives import all_reduce

        group, R, _ = ctx
        aux = E * torch.sum((me / R) * (all_reduce(fe, group) / R))
    C = min(int(math.ceil(T * top_k / E * capacity_factor)), T)
    y = _dispatch(enter(xt), enter(weights), ids, w_gate, w_up, w_down,
                  top_k, C, **experts)
    return y.reshape(B, S, d), aux
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

def softmax_xent(logits, labels, mask=None, mask_total=None):
    """Token-level cross entropy, f32 accumulation.  logits (..., V).
    ``mask_total`` replaces Σ mask in the denominator (the global count of
    a batch whose rows are split over ranks)."""
    logits = logits.to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - ll
    return _masked_mean(nll, mask, mask_total)


def _masked_mean(nll, mask, mask_total):
    if mask is not None:
        total = torch.sum(mask) if mask_total is None else mask_total
        return torch.sum(nll * mask) / (total + 1e-6)
    return torch.mean(nll)


def vocab_parallel_xent(logits, labels, mask=None, mask_total=None, *,
                        first: int, amax, total):
    """:func:`softmax_xent` on a rank's block of the vocabulary (the rows
    from ``first`` on, the logits split over the model axis): the max
    over every rank (``amax``, an all-reduce of the max, no gradient), Σ
    exp and the target's logit each summed over the ranks (``total``, an
    all-reduce of the sum whose backward is the identity)."""
    logits = logits.to(F32)
    Vl = logits.shape[-1]
    m = amax(torch.amax(logits.detach(), dim=-1))
    se = total(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    t = labels.long() - first
    mine = (t >= 0) & (t < Vl)
    ll = torch.gather(logits, -1, t.clamp(0, Vl - 1)[..., None])[..., 0]
    ll = total(torch.where(mine, ll, 0.0))
    nll = torch.log(se) + m - ll
    return _masked_mean(nll, mask, mask_total)
