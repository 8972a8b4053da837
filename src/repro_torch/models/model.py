"""Model: param specs, forward, prefill, lock-step and ragged decode.

Counterpart of ``repro/models/model.py`` for two families: ``dense`` (GQA
attention with optional QKV bias / QK-norm, RoPE, RMSNorm, SwiGLU, tied or
separate unembedding) and ``ssm`` (Mamba2 blocks: projections, depthwise
causal conv, the chunked SSD scan, gated RMSNorm).  Params are a nested
dict of tensors with the JAX tree's paths and its stacked-over-layers
layout (``blocks/attn/wq`` is ``(L, d, H, Dh)``); a Python loop over layers
takes the place of ``jax.lax.scan``.  One device, no mesh: ``_shard_act``
has no counterpart.

The SSM decode cache holds per-layer conv and SSD states
(``{"ssm": {"conv", "ssd"}}``, the JAX layout) and no positions buffer.
With ``cfg.use_ssd_kernel`` every SSD layer's intra-chunk part goes
through ``kernels.ops.ssd_chunk`` (the CUDA kernel on the card, its plain
version on the CPU); the kernel has no backward either.

With ``cfg.use_flash_attention`` every prefill layer's attention goes
through ``kernels.ops.flash_attention``: the CUDA kernel on the card, its
plain version on the CPU.  Decode attention is plain PyTorch, as in the
JAX package.  The flash kernel has no backward, so training
(:func:`loss_fn` under autograd) runs with ``use_flash_attention=False``;
the kernel's wrapper raises rather than drop the gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels import ops
from . import layers as L
from .specs import Spec, count_params, init_tree, torch_dtype

F32 = torch.float32
_LATER = ("is not ported yet; the other model families are a later slice "
          "(ROADMAP.md queue 1, 'The other model families')")
FAMILIES = ("dense", "ssm")


def _require_family(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} {_LATER}")


# ============================================================================
# parameter specs
# ============================================================================

def _attn_specs(cfg: ArchConfig, stacked: Optional[int]):
    pre = (stacked,) if stacked else ()
    ax = ("layers",) if stacked else ()
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = {
        "norm": Spec(pre + (d,), ax + ("embed",), "ones"),
        "wq": Spec(pre + (d, H, Dh), ax + ("embed", "heads", "head"), "fan_in"),
        "wk": Spec(pre + (d, KV, Dh), ax + ("embed", "kv_heads", "head"), "fan_in"),
        "wv": Spec(pre + (d, KV, Dh), ax + ("embed", "kv_heads", "head"), "fan_in"),
        "wo": Spec(pre + (H, Dh, d), ax + ("heads", "head", "embed"), "fan_in"),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec(pre + (H, Dh), ax + ("heads", "head"), "zeros")
        s["bk"] = Spec(pre + (KV, Dh), ax + ("kv_heads", "head"), "zeros")
        s["bv"] = Spec(pre + (KV, Dh), ax + ("kv_heads", "head"), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = Spec(pre + (Dh,), ax + ("head",), "ones")
        s["k_norm"] = Spec(pre + (Dh,), ax + ("head",), "ones")
    return s


def _mlp_specs(cfg: ArchConfig, stacked: Optional[int], ff: int):
    pre = (stacked,) if stacked else ()
    ax = ("layers",) if stacked else ()
    d = cfg.d_model
    return {
        "norm": Spec(pre + (d,), ax + ("embed",), "ones"),
        "w_gate": Spec(pre + (d, ff), ax + ("embed", "ff"), "fan_in"),
        "w_up": Spec(pre + (d, ff), ax + ("embed", "ff"), "fan_in"),
        "w_down": Spec(pre + (ff, d), ax + ("ff", "embed"), "fan_in"),
    }


def _mamba_specs(cfg: ArchConfig, stacked: Optional[int]):
    pre = (stacked,) if stacked else ()
    ax = ("layers",) if stacked else ()
    d, di, N, Hs, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_conv)
    conv_dim = di + 2 * N
    return {
        "norm": Spec(pre + (d,), ax + ("embed",), "ones"),
        "in_z": Spec(pre + (d, di), ax + ("embed", "d_inner"), "fan_in"),
        "in_x": Spec(pre + (d, di), ax + ("embed", "d_inner"), "fan_in"),
        "in_B": Spec(pre + (d, N), ax + ("embed", "state"), "fan_in"),
        "in_C": Spec(pre + (d, N), ax + ("embed", "state"), "fan_in"),
        "in_dt": Spec(pre + (d, Hs), ax + ("embed", "ssm_heads"), "fan_in"),
        "conv_w": Spec(pre + (K, conv_dim), ax + ("conv", "d_inner"), "fan_in"),
        "conv_b": Spec(pre + (conv_dim,), ax + ("d_inner",), "zeros"),
        "A_log": Spec(pre + (Hs,), ax + ("ssm_heads",), "mamba_A", dtype="float32"),
        "D": Spec(pre + (Hs,), ax + ("ssm_heads",), "ones", dtype="float32"),
        "dt_bias": Spec(pre + (Hs,), ax + ("ssm_heads",), "mamba_dt", dtype="float32"),
        "gate_norm": Spec(pre + (di,), ax + ("d_inner",), "ones"),
        "out_proj": Spec(pre + (di, d), ax + ("d_inner", "embed"), "fan_in"),
    }


def param_specs(cfg: ArchConfig) -> dict:
    _require_family(cfg)
    d, V = cfg.d_model, cfg.vocab
    specs: dict = {
        "embed": Spec((V, d), ("vocab", "embed"), "normal"),
        "final_norm": Spec((d,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((d, V), ("embed", "vocab"), "fan_in")
    nl = cfg.n_layers
    if cfg.family == "ssm":
        specs["blocks"] = {"mamba": _mamba_specs(cfg, nl)}
    else:
        specs["blocks"] = {"attn": _attn_specs(cfg, nl),
                           "mlp": _mlp_specs(cfg, nl, cfg.d_ff)}
    return specs


def init_params(cfg: ArchConfig, seed: int, device="cuda") -> dict:
    """Random params from ``seed`` (the port's own streams, see
    ``specs.init_tree``), placed on ``device``."""
    return init_tree(param_specs(cfg), seed, resolve_device(device))


def n_params(cfg: ArchConfig) -> int:
    return count_params(param_specs(cfg))


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s slice of a stacked param tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ============================================================================
# block applications
# ============================================================================

def _qkv(cfg, p, x):
    q = L.einsum("bsd,dhk->bshk", x, p["wq"])
    k = L.einsum("bsd,dhk->bshk", x, p["wk"])
    v = L.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _apply_attn(cfg, p, h, *, positions, window=None, return_kv=False):
    """Pre-norm causal self-attention block."""
    x = L.rms_norm(h, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, x)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if cfg.use_flash_attention:
        o = ops.flash_attention(q, k, v, causal=True, window=window)
    else:
        o = L.attention(q, k, v, causal=True, window=window)
    out = h + L.einsum("bshk,hkd->bsd", o, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def _apply_mlp(cfg, p, h):
    x = L.rms_norm(h, p["norm"], cfg.norm_eps)
    return h + L.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _mamba_inner(p, x_n):
    """Projections of a normalised input (B,S,d) → (z, x, B, C, dt)."""
    z = L.einsum("bsd,de->bse", x_n, p["in_z"])
    xi = L.einsum("bsd,de->bse", x_n, p["in_x"])
    Bp = L.einsum("bsd,dn->bsn", x_n, p["in_B"])
    Cp = L.einsum("bsd,dn->bsn", x_n, p["in_C"])
    dt = L.einsum("bsd,dh->bsh", x_n, p["in_dt"])
    return z, xi, Bp, Cp, dt


def _gated_out(cfg, p, h, y, z):
    """y (B,S,d_inner) gated by silu(z), normalised, projected, added to h;
    silu in f32 with one cast, as in the JAX package."""
    y = L.rms_norm(y * F.silu(z.to(F32)).to(h.dtype), p["gate_norm"],
                   cfg.norm_eps)
    return h + L.einsum("bse,ed->bsd", y, p["out_proj"])


def _apply_mamba(cfg, p, h, return_state=False):
    """Mamba2 block over a sequence.  With ``return_state`` also returns
    (conv state: the last K−1 pre-conv inputs, final SSD state)."""
    B, S, _ = h.shape
    di, N, Hs, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    x_n = L.rms_norm(h, p["norm"], cfg.norm_eps)
    z, xi, Bp, Cp, dt = _mamba_inner(p, x_n)
    conv_in = torch.cat([xi, Bp, Cp], dim=-1)
    conv_out = L.causal_conv1d(conv_in, p["conv_w"], p["conv_b"])
    xi, Bp, Cp = torch.split(conv_out, [di, N, N], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, S, Hs, P)
    y, hT = L.ssd_chunked(xh, dt, A, Bp, Cp, chunk=min(cfg.ssm_chunk, S),
                          use_kernel=cfg.use_ssd_kernel)
    y = y + xh.to(F32) * p["D"][None, None, :, None]
    out = _gated_out(cfg, p, h, y.reshape(B, S, di).to(h.dtype), z)
    if return_state:
        K = cfg.ssm_conv
        return out, (conv_in[:, S - (K - 1):, :], hT)
    return out


# ============================================================================
# forward / prefill
# ============================================================================

def _embed(cfg, params, tokens):
    return params["embed"][tokens].to(torch_dtype(cfg.dtype))


def _unembed(cfg, params, h):
    if cfg.tie_embeddings:
        return L.einsum("bsd,vd->bsv", h, params["embed"])
    return L.einsum("bsd,dv->bsv", h, params["lm_head"])


def forward_logits(cfg: ArchConfig, params, batch, window=None):
    """Full-sequence forward → (logits (B,S,V), aux_loss = 0.0)."""
    _require_family(cfg)
    if window is None:
        window = cfg.sliding_window
    tokens = batch["tokens"]
    h = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        if cfg.family == "ssm":
            h = _apply_mamba(cfg, p["mamba"], h)
            continue
        h = _apply_attn(cfg, p["attn"], h, positions=positions, window=window)
        h = _apply_mlp(cfg, p["mlp"], h)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h), 0.0


def loss_fn(cfg: ArchConfig, params, batch, example_weights=None,
            aux_coeff: float = 0.01, window=None):
    """Next-token CE (neither ported family has an aux loss).  ``example_weights``
    (B,) carries the AsGrad worker-participation mask (see
    ``distributed.async_trainer``).  Returns (loss, {"ce", "aux"}).

    ``cfg.remat`` other than ``"none"`` raises: activation recomputation
    (``jax.checkpoint`` in the JAX package) is not ported, and running
    without it would silently change the memory a config asks for."""
    if cfg.remat != "none":
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet (activation "
            "recomputation); train with remat='none'")
    logits, aux = forward_logits(cfg, params, batch, window=window)
    labels = batch["tokens"][:, 1:]
    lg = logits[:, :-1]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=lg.device)
    if example_weights is not None:
        mask = mask * example_weights[:, None]
    ce = L.softmax_xent(lg, labels, mask)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + aux_coeff * aux, {"ce": ce, "aux": aux}


def _ring_from_seq(k_seq, v_seq, W: int):
    """(L,B,S,KV,D) stacked per-layer k/v → ring cache of the last W tokens,
    placed at slot = pos mod W, plus the positions buffer (−1 = empty)."""
    S = k_seq.shape[2]
    take = min(W, S)
    pos = torch.arange(S - take, S, device=k_seq.device)
    slots = pos % W
    kc = k_seq.new_zeros(k_seq.shape[:2] + (W,) + k_seq.shape[3:])
    vc = torch.zeros_like(kc)
    kc[:, :, slots] = k_seq[:, :, S - take:]
    vc[:, :, slots] = v_seq[:, :, S - take:]
    positions = torch.full((W,), -1, dtype=torch.int32, device=k_seq.device)
    positions[slots] = pos.to(torch.int32)
    return kc, vc, positions


def prefill(cfg: ArchConfig, params, batch, ctx_len: Optional[int] = None):
    """Process the prompt, return (last-token logits (B,V), decode cache).

    The cache matches ``cache_specs(cfg, B, ctx_len)``; ctx_len defaults to
    the prompt length.  Only the last position is unembedded.  An SSM
    prompt must hold at least ``ssm_conv − 1`` tokens (the conv state is
    the last K−1 pre-conv inputs), and the SSD chunk, ``min(ssm_chunk, S)``,
    must divide its length."""
    _require_family(cfg)
    window = cfg.sliding_window
    tokens = batch["tokens"]
    S = tokens.shape[1]
    ctx = ctx_len or S
    W = min(cfg.sliding_window or ctx, ctx)
    h = _embed(cfg, params, tokens)
    if cfg.family == "ssm":
        if S < cfg.ssm_conv - 1:
            raise ValueError(f"an SSM prompt needs at least ssm_conv - 1 = "
                             f"{cfg.ssm_conv - 1} tokens, got {S}")
        convs, ssds = [], []
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"], i)
            h, (cs, ss) = _apply_mamba(cfg, p["mamba"], h, return_state=True)
            convs.append(cs)
            ssds.append(ss)
        cache = {"ssm": {"conv": torch.stack(convs), "ssd": torch.stack(ssds)}}
        h = L.rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        return _unembed(cfg, params, h)[:, 0], cache
    positions = torch.arange(S, device=tokens.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        h, (k, v) = _apply_attn(cfg, p["attn"], h, positions=positions,
                                window=window, return_kv=True)
        h = _apply_mlp(cfg, p["mlp"], h)
        ks.append(k)
        vs.append(v)
    kc, vc, posbuf = _ring_from_seq(torch.stack(ks), torch.stack(vs), W)
    cache = {"self": {"k": kc, "v": vc}, "positions": posbuf}
    h = L.rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h)[:, 0], cache


# ============================================================================
# decode (serve_step): lock-step and ragged
# ============================================================================

def cache_specs(cfg: ArchConfig, batch: int, ctx_len: int, *,
                ragged: bool = False) -> dict:
    """Cache tree as Specs: ring k/v caches and one shared (W,) positions
    buffer (dense), or per-layer conv states in the param dtype and f32 SSD
    states (ssm, no positions).

    ``ragged=True`` declares the slot server's cache: the positions buffer
    grows a batch axis, (batch, W), so each row tracks its own positions.
    Every other leaf already carries a batch axis and is unchanged."""
    _require_family(cfg)
    if cfg.family == "ssm":
        nl, conv_dim = cfg.n_layers, cfg.d_inner + 2 * cfg.ssm_state
        return {"ssm": {
            "conv": Spec((nl, batch, cfg.ssm_conv - 1, conv_dim),
                         ("layers", "batch", None, "d_inner"), "zeros",
                         cfg.dtype),
            "ssd": Spec((nl, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state),
                        ("layers", "batch", "ssm_heads", None, None),
                        "zeros", "float32"),
        }}
    W = min(cfg.sliding_window or ctx_len, ctx_len)
    KV, Dh, nl = cfg.n_kv_heads, cfg.d_head, cfg.n_layers
    axes = ("layers", "batch", "ctx", "kv_heads", "head")
    return {
        "self": {"k": Spec((nl, batch, W, KV, Dh), axes, "zeros", cfg.dtype),
                 "v": Spec((nl, batch, W, KV, Dh), axes, "zeros", cfg.dtype)},
        "positions": (Spec((batch, W), ("batch", "ctx"), "zeros", "int32")
                      if ragged else Spec((W,), ("ctx",), "zeros", "int32")),
    }


def init_cache(cfg: ArchConfig, batch: int, ctx_len: int, device="cuda", *,
               ragged: bool = False) -> dict:
    tree = init_tree(cache_specs(cfg, batch, ctx_len, ragged=ragged), 0,
                     resolve_device(device))
    if "positions" in tree:
        tree["positions"] -= 1             # −1 = empty slot
    return tree


def _decode_attn(cfg, p, h, kc, vc, cache_positions, pos, window, slot,
                 rows=None):
    """One-token attention; writes this token's k/v into ring slot ``slot``
    of ``kc`` / ``vc`` in place, then attends.  Lock-step: ``pos`` and
    ``slot`` are ints.  Ragged: ``pos`` and ``slot`` are (B,) tensors and
    ``rows`` is ``arange(B)``, so each row writes its own slot."""
    x = L.rms_norm(h, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, x)
    posv = pos[:, None] if rows is not None else torch.full(
        (1,), pos, device=h.device)
    q = L.rope(q, posv, cfg.rope_theta)
    k = L.rope(k, posv, cfg.rope_theta)
    if rows is not None:
        kc[rows, slot] = k[:, 0]
        vc[rows, slot] = v[:, 0]
    else:
        kc[:, slot] = k[:, 0]
        vc[:, slot] = v[:, 0]
    o = L.decode_attention(q, kc, vc, cache_positions, pos, window=window)
    return h + L.einsum("bshk,hkd->bsd", o, p["wo"])


def _decode_mamba(cfg, p, h, conv_state, ssd_state):
    """One-token Mamba2 block → (h', conv state', SSD state')."""
    B = h.shape[0]
    di, N, Hs, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    x_n = L.rms_norm(h, p["norm"], cfg.norm_eps)
    z, xi, Bp, Cp, dt = _mamba_inner(p, x_n)
    conv_in = torch.cat([xi, Bp, Cp], dim=-1)[:, 0]           # (B, conv_dim)
    y_conv, conv_state = L.conv1d_decode(conv_state, conv_in, p["conv_w"],
                                         p["conv_b"])
    xi, Bp, Cp = torch.split(y_conv, [di, N, N], dim=-1)
    dt = F.softplus(dt[:, 0].to(F32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, Hs, P)
    y, ssd_state = L.ssd_decode_step(ssd_state, xh, dt, A, Bp, Cp)
    y = y + xh.to(F32) * p["D"][None, :, None]
    out = _gated_out(cfg, p, h, y.reshape(B, 1, di).to(h.dtype), z)
    return out, conv_state, ssd_state


def decode_step(cfg: ArchConfig, params, cache, tokens, pos, ctx_len: int):
    """serve_step: ONE new token per sequence against the cache.

    tokens: (B,) integer tensor; pos: the current absolute position, shared
    by every row (lock-step: an int), or a (B,) integer tensor of per-row
    positions (ragged: the slot server, against a cache made with
    ``ragged=True``).  The SSM family does not read it.  Where the JAX
    package donates the cache, the port updates it in place: the positions
    buffer and each layer's ring slot ``pos mod W`` (dense), or each
    layer's conv and SSD states (ssm), are written, and the same dict is
    returned.  The ragged path reads no tensor value on the host, so a CUDA
    graph can capture it.  Returns (logits (B, V), cache)."""
    _require_family(cfg)
    ragged = isinstance(pos, torch.Tensor) and pos.dim() == 1
    if not ragged:
        pos = int(pos)
    h = _embed(cfg, params, tokens[:, None])            # (B,1,d)
    if cfg.family == "ssm":
        conv, ssd = cache["ssm"]["conv"], cache["ssm"]["ssd"]
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"], i)
            h, cs, ss = _decode_mamba(cfg, p["mamba"], h, conv[i], ssd[i])
            conv[i] = cs
            ssd[i] = ss
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return _unembed(cfg, params, h)[:, 0], cache
    W = min(cfg.sliding_window or ctx_len, ctx_len)
    cpos = cache["positions"]
    rows = None
    if ragged:
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        slot = (pos % W).long()
        cpos[rows, slot] = pos.to(cpos.dtype)
    else:
        slot = pos % W
        cpos[slot] = pos
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        h = _decode_attn(cfg, p["attn"], h, cache["self"]["k"][i],
                         cache["self"]["v"][i], cpos, pos,
                         cfg.sliding_window, slot, rows)
        h = _apply_mlp(cfg, p["mlp"], h)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h)[:, 0], cache


# ============================================================================
# batch specs
# ============================================================================

def batch_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """Train/prefill batch as Specs (dense and ssm: int32 tokens)."""
    _require_family(cfg)
    return {"tokens": Spec((batch, seq), ("batch", "seq"), "zeros", "int32")}
