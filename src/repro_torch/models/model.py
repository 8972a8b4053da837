"""Model: param specs, forward, prefill, lock-step and ragged decode.

Counterpart of ``repro/models/model.py`` for all six families: ``dense``
(GQA attention with optional QKV bias / QK-norm, RoPE, RMSNorm, SwiGLU,
tied or separate unembedding), ``moe`` (the dense attention with a
capacity-dispatched top-k MoE of SwiGLU experts plus shared experts in
place of the MLP), ``ssm`` (Mamba2 blocks: projections, depthwise causal
conv, the chunked SSD scan, gated RMSNorm), ``hybrid`` (Mamba2 layers with
ONE shared attention + MLP block applied before every ``attn_every`` of
them, its weights reused at each insertion, and a tail of the remaining
Mamba2 layers), ``audio`` (an encoder-decoder: stubbed frame embeddings
through ``frontend_proj`` and a bidirectional encoder, then decoder layers
of causal self-attention, cross-attention to the encoder's memory and an
MLP) and ``vlm`` (the dense decoder, with stubbed patch embeddings
projected by ``projector`` into the first positions).  Params are a nested
dict of tensors with the JAX tree's paths and its stacked-over-layers
layout (``blocks/attn/wq`` is ``(L, d, H, Dh)``); a Python loop over
layers takes the place of ``jax.lax.scan`` (of the two nested scans, for
the hybrid).  ``_shard_act``'s call sites go through
``distributed.sharding.shard_activation``, the identity.  Under a
data-parallel context (the trainer's ranked step) each rank holds its rows
of the batch: :func:`loss_fn` returns the rank's share of the loss, and
the MoE dispatches in JAX's groups (``layers.moe_ffn``).  Under a model
axis larger than 1 (``distributed.sharding.model_context``) every family
runs tensor-parallel on the rank's blocks of the params and the cache
(:mod:`repro_torch.models.tp`), the ragged decode (the slot lane's step)
included; under rules that split the residual on ``seq`` (``SEQ_PARALLEL_
RULES``) the sequence entry points (:func:`forward_logits`,
:func:`loss_fn`, :func:`prefill`) run sequence-parallel: each model rank
holds its block of the rows between blocks (``models.tp.TP.for_seq``),
where JAX's ``_shard_act`` pins the same layout.

The SSM decode cache holds per-layer conv and SSD states
(``{"ssm": {"conv", "ssd"}}``, the JAX layout) and no positions buffer.
The hybrid's holds the g = n_layers // attn_every insertions' ring
(``attn``) and positions, the grouped layers' states flat (``ssm``, g·k
layers: layer i is group i // k, inner layer i % k) and, when n_layers is
not a multiple of k, the tail's (``ssm_tail``).  The audio cache adds
each decoder layer's cross-attention k/v of the encoder memory
(``cross_k`` / ``cross_v``, (L, B, S_frames, KV, Dh)); ``cache_specs``
declares them with ``ctx_len`` rows, as the JAX package does, so a cache
to decode from comes from :func:`prefill`.
With ``cfg.use_ssd_kernel`` every SSD layer's intra-chunk part goes
through ``kernels.ops.ssd_chunk`` (the CUDA kernel on the card, its plain
version on the CPU); the kernel has no backward either.

With ``cfg.use_flash_attention`` every prefill layer's attention goes
through ``kernels.ops.flash_attention``: the CUDA kernel on the card, its
plain version on the CPU; the audio encoder's and the cross-attention run
it non-causal.  Decode attention is plain PyTorch, as in the JAX package.
The flash kernel has no backward, so training (:func:`loss_fn` under
autograd) runs with ``use_flash_attention=False``; the kernel's wrapper
raises rather than drop the gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import layers as L
from .specs import Spec, count_params, init_tree, torch_dtype
from .tp import TP, attn_local, cross_decode_local, decode_local, \
    mamba_local, mamba_project, mamba_step_dt, mamba_step_local

F32 = torch.float32
FAMILIES = ("dense", "ssm", "hybrid", "moe", "audio", "vlm")


def _require_family(cfg: ArchConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the families are "
                         f"{FAMILIES}")


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


def _moe_specs(cfg: ArchConfig, stacked: int):
    pre, ax = (stacked,), ("layers",)
    d, E, fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s = {
        "norm": Spec(pre + (d,), ax + ("embed",), "ones"),
        "router": Spec(pre + (d, E), ax + ("embed", "experts"), "fan_in",
                       dtype="float32"),
        "w_gate": Spec(pre + (E, d, fe), ax + ("experts", "embed", "ff"), "fan_in"),
        "w_up": Spec(pre + (E, d, fe), ax + ("experts", "embed", "ff"), "fan_in"),
        "w_down": Spec(pre + (E, fe, d), ax + ("experts", "ff", "embed"), "fan_in"),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.moe_d_ff
        s["shared"] = _mlp_specs(cfg, stacked, fs)
        del s["shared"]["norm"]  # shares the moe norm
    return s


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
    elif cfg.family == "hybrid":
        g, k, rem = _groups(cfg)
        specs["blocks"] = {"mamba": _mamba_specs(cfg, g * k)}
        if rem:
            specs["tail"] = {"mamba": _mamba_specs(cfg, rem)}
        specs["shared_attn"] = _attn_specs(cfg, None)
        specs["shared_mlp"] = _mlp_specs(cfg, None, cfg.d_ff)
    elif cfg.family == "moe":
        specs["blocks"] = {"attn": _attn_specs(cfg, nl),
                           "moe": _moe_specs(cfg, nl)}
    elif cfg.family == "audio":
        specs["frontend_proj"] = Spec((cfg.frontend_dim, d),
                                      (None, "embed"), "fan_in")
        specs["enc_blocks"] = {"attn": _attn_specs(cfg, cfg.enc_layers),
                               "mlp": _mlp_specs(cfg, cfg.enc_layers,
                                                 cfg.d_ff)}
        specs["enc_norm"] = Spec((d,), ("embed",), "ones")
        specs["blocks"] = {"attn": _attn_specs(cfg, nl),
                           "cross": _attn_specs(cfg, nl),
                           "mlp": _mlp_specs(cfg, nl, cfg.d_ff)}
    else:
        specs["blocks"] = {"attn": _attn_specs(cfg, nl),
                           "mlp": _mlp_specs(cfg, nl, cfg.d_ff)}
    if cfg.family == "vlm":
        specs["projector"] = Spec((cfg.vision_dim, d), (None, "embed"),
                                  "fan_in")
    return specs


def _groups(cfg: ArchConfig) -> tuple:
    """The hybrid's layout: (g insertions of the shared block, k Mamba2
    layers after each, rem tail layers)."""
    k = cfg.attn_every
    g = cfg.n_layers // k
    return g, k, cfg.n_layers - g * k


def init_params(cfg: ArchConfig, seed: int, device="cuda",
                shardings=None) -> dict:
    """Random params from ``seed`` (the port's own streams, see
    ``specs.init_tree``), placed on ``device``.  With ``shardings`` (a
    tree of ``distributed.sharding.NamedSharding``) each leaf is this
    rank's block of the whole leaf, taken as soon as it is drawn."""
    return init_tree(param_specs(cfg), seed, resolve_device(device),
                     shardings=shardings)


def n_params(cfg: ArchConfig) -> int:
    return count_params(param_specs(cfg))


def n_active_params(cfg: ArchConfig) -> int:
    """Active parameters per token (MoE counts top_k + shared experts)."""
    if cfg.family != "moe":
        return n_params(cfg)
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff * cfg.n_layers
    return n_params(cfg) - (cfg.n_experts - cfg.top_k) * per_expert


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s slice of a stacked param tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ============================================================================
# block applications
# ============================================================================

def _tp_of(cfg, tp):
    """``tp``, or the active context's (``models.tp.TP.active``): an entry
    point resolves it once and hands it to every layer."""
    return TP.active(cfg) if tp is None else tp


def _leaf(params, name, tp):
    """Top-level leaf ``name``, whole (gathered under ``tp``)."""
    return params[name] if tp is None else tp.leaf(params, name)


def _apply_attn(cfg, p, h, *, causal=True, positions=None, kv_h=None,
                window=None, return_kv=False, tp=None):
    """Pre-norm attention block.  ``kv_h``: a cross-attention memory, the
    source of k and v (un-normed; no RoPE, never causal); otherwise
    self-attention, with RoPE at ``positions`` when they are given.  With
    ``tp`` (a ``models.tp.TP``) the rank's heads of it."""
    if tp is not None:
        return tp.attn(p, h, positions=positions, window=window,
                       return_kv=return_kv, causal=causal, src=kv_h)
    x = L.rms_norm(h, p["norm"], cfg.norm_eps)
    o, k, v = attn_local(cfg, p, x, 0, positions=positions, window=window,
                         causal=causal, src=kv_h)
    out = h + o
    if return_kv:
        return out, (k, v)
    return out


def _apply_mlp(cfg, p, h, tp=None):
    if tp is not None:
        return tp.mlp(p, h)
    x = L.rms_norm(h, p["norm"], cfg.norm_eps)
    return h + L.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _apply_moe(cfg, p, h, tp=None):
    """Pre-norm MoE block (the shared experts read the same norm) →
    (h', aux)."""
    if tp is not None:
        return tp.moe(p, h)
    x = L.rms_norm(h, p["norm"], cfg.norm_eps)
    y, aux = L.moe_ffn(x, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                       cfg.top_k, cfg.capacity_factor)
    if "shared" in p:
        sp = p["shared"]
        y = y + L.swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return h + y, aux


def _apply_mamba(cfg, p, h, return_state=False, tp=None):
    """Mamba2 block over a sequence.  With ``return_state`` also returns
    (conv state: the last K−1 pre-conv inputs, final SSD state); with
    ``tp`` the rank's SSM heads of it (the conv state whole, the SSD
    state the rank's heads')."""
    if tp is not None:
        return tp.mamba(p, h, return_state)
    x_n = L.rms_norm(h, p["norm"], cfg.norm_eps)
    out, conv_in, hT = mamba_local(cfg, p, x_n, p["conv_w"], p["conv_b"])
    out = h + out
    if return_state:
        S, K = h.shape[1], cfg.ssm_conv
        return out, (conv_in[:, S - (K - 1):, :], hT)
    return out


# ============================================================================
# forward / prefill
# ============================================================================

def _embed(cfg, params, tokens, tp=None):
    if tp is not None:
        return tp.embed(params["embed"], tokens)
    return params["embed"][tokens].to(torch_dtype(cfg.dtype))


def _final_norm(cfg, params, h, tp=None):
    return L.rms_norm(h, _leaf(params, "final_norm", tp), cfg.norm_eps)


def _unembed(cfg, params, h, tp=None):
    """The logits of ``h``, whole over the vocabulary (gathered over the
    model ranks under tensor parallelism)."""
    if tp is not None:
        return tp.full_logits(params, h)
    if cfg.tie_embeddings:
        return L.einsum("bsd,vd->bsv", h, params["embed"])
    return L.einsum("bsd,dv->bsv", h, params["lm_head"])


def _shard_act(x, axes=None):
    """The JAX package's activation constraint, named as there
    (``distributed.sharding.shard_activation``)."""
    from ..distributed.sharding import shard_activation
    if axes is None:
        axes = ("batch", "seq", "act_embed") if x.dim() == 3 else \
            ("batch",) + (None,) * (x.dim() - 1)
    return shard_activation(x, axes)


def _runner(cfg):
    """``run(fn, *args)``: ``fn(*args)``, inside
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` under
    autograd with ``cfg.remat == "full"``: only the block's inputs are
    kept, and the backward pass recomputes the rest, as JAX's ``_scan(...,
    remat)`` does with ``jax.checkpoint``.  The recomputation runs under
    the forward's activation context (a CUDA backward runs on autograd's
    own thread, where the context variable is unset), so a ranked block
    repeats its collectives there."""
    from ..distributed.sharding import bound_to_context
    remat = cfg.remat == "full" and torch.is_grad_enabled()

    def run(fn, *args):
        return (checkpoint(bound_to_context(fn), *args, use_reentrant=False)
                if remat else fn(*args))
    return run


def _gathered(zero, p, kind=None):
    """A layer's param blocks ``p`` whole over the data axes under
    per-leaf ZeRO (``zero``: a ``models.tp.ZeroGather``; ``p`` itself
    without one): by its kinds of block, or as one block of ``kind``."""
    if zero is None:
        return p
    return zero.layer(p) if kind is None else zero.take(p, kind)


def _decoder_stack(cfg, params, h, positions, window, memory=None,
                   tp=None, zero=None):
    """Every layer of the family over the sequence → (h, aux).  ``memory``:
    the audio encoder's output, which each decoder layer cross-attends to.

    With ``cfg.remat == "full"`` under autograd each block is recomputed in
    the backward pass (:func:`_runner`; the hybrid's shared block and each
    of its Mamba2 layers are blocks of their own).  Under per-leaf ZeRO
    (``zero``) each block gathers its layer's params over the data axes
    inside the function that :func:`_runner` checkpoints: with ``remat``
    "full" the gathered layer is freed after use and gathered again in the
    backward; with "none" autograd keeps every gathered layer alive."""
    run = _runner(cfg)

    def mamba(p, x):
        return _apply_mamba(cfg, _gathered(zero, p, "mamba"), x, tp=tp)

    blocks = params["blocks"]
    if cfg.family == "hybrid":
        g, k, rem = _groups(cfg)

        def shared(x):
            # the shared block's leaves gathered at each use
            sa = _gathered(zero, params["shared_attn"], "attn")
            x = _apply_attn(cfg, sa, x, positions=positions, window=window,
                            tp=tp)
            sm = _gathered(zero, params["shared_mlp"], "mlp")
            return _apply_mlp(cfg, sm, x, tp)

        for i in range(g * k):
            if i % k == 0:
                h = run(shared, h)
            h = run(mamba, _layer(blocks["mamba"], i), h)
        for i in range(rem):
            h = run(mamba, _layer(params["tail"]["mamba"], i), h)
        return h, 0.0
    if cfg.family == "moe":
        def block(p, x):
            p = _gathered(zero, p)
            x = _apply_attn(cfg, p["attn"], x, positions=positions,
                            window=window, tp=tp)
            return _apply_moe(cfg, p["moe"], x, tp)

        aux = torch.zeros((), dtype=F32, device=h.device)
        for i in range(cfg.n_layers):
            h, a = run(block, _layer(blocks, i), h)
            aux = aux + a
        return h, aux / cfg.n_layers
    if cfg.family == "audio":
        def block(p, x, mem):
            p = _gathered(zero, p)
            x = _apply_attn(cfg, p["attn"], x, positions=positions,
                            window=window, tp=tp)
            x = _apply_attn(cfg, p["cross"], x, kv_h=mem, tp=tp)
            return _apply_mlp(cfg, p["mlp"], x, tp)

        for i in range(cfg.n_layers):
            h = run(block, _layer(blocks, i), h, memory)
        return h, 0.0

    def block(p, x):
        p = _gathered(zero, p)
        if cfg.family == "ssm":
            return _apply_mamba(cfg, p["mamba"], x, tp=tp)
        x = _apply_attn(cfg, p["attn"], x, positions=positions, window=window,
                        tp=tp)
        return _apply_mlp(cfg, p["mlp"], x, tp)

    for i in range(cfg.n_layers):
        h = run(block, _layer(blocks, i), h)
    return h, 0.0


def _encoder_stack(cfg, params, frames, tp=None, zero=None):
    """The audio encoder over stubbed frame embeddings (B, S, frontend_dim):
    ``frontend_proj``, bidirectional self-attention blocks with RoPE (remat
    and per-leaf ZeRO as in :func:`_decoder_stack`), then ``enc_norm``.
    Where the rules split the frames' sequence, each rank runs the
    encoder on its rows and the memory is gathered whole at the end."""
    S = frames.shape[1]
    tp = None if tp is None else tp.for_seq(S)
    if tp is not None and tp.seq:
        frames = tp.rows_of(frames)
    h = L.einsum("bsf,fd->bsd", frames.to(torch_dtype(cfg.dtype)),
                 _leaf(params, "frontend_proj", tp))
    positions = torch.arange(S, device=h.device)
    run = _runner(cfg)

    def block(p, x):
        p = _gathered(zero, p)
        x = _apply_attn(cfg, p["attn"], x, causal=False, positions=positions,
                        tp=tp)
        return _apply_mlp(cfg, p["mlp"], x, tp)

    for i in range(cfg.enc_layers):
        h = run(block, _layer(params["enc_blocks"], i), h)
    h = L.rms_norm(h, _leaf(params, "enc_norm", tp), cfg.norm_eps)
    # every decoder rank reads the whole memory the same way (its heads or
    # its rows, each entered by a copy), so each holds its whole gradient
    return tp.gather_seq(h, partial=False) if tp is not None and tp.seq \
        else h


def _embed_input(cfg, params, batch, tp=None, zero=None):
    """The input embedding of training and prefill → (h, cross-attention
    memory or None).  audio: the encoder over ``batch["frames"]`` gives
    the memory.  vlm: ``batch["patches"]`` (B, P, vision_dim) through
    ``projector`` replace the first P token embeddings; a prompt shorter
    than P is lengthened to P, as in the JAX package, where a prompt of 2
    to P − 1 tokens then fails (its positions no longer broadcast against
    the sequence), so such a prompt is refused here.  In seq mode
    (``tp.seq``) h is the rank's rows: the patches that fall in them take
    their place (the first positions: rank 0's rows, and the next ranks'
    where P is longer)."""
    memory = None
    if cfg.family == "audio":
        memory = _encoder_stack(cfg, params, batch["frames"], tp, zero)
    tokens = batch["tokens"]
    h = _embed(cfg, params, tokens, tp)
    if cfg.family == "vlm":
        patches = batch["patches"]
        P, S = patches.shape[1], tokens.shape[1]
        if 1 < S < P:
            raise ValueError(f"a vlm prompt of {S} tokens is shorter than "
                             f"its {P} patches (the JAX package's shapes "
                             "break there too)")
        seq = tp is not None and tp.seq
        n = max(0, min(P, tp.lo + tp.rows) - tp.lo) if seq else P
        if seq:
            patches = patches[:, tp.lo:tp.lo + n]
        patches = L.einsum("bpv,vd->bpd", patches.to(torch_dtype(cfg.dtype)),
                           _leaf(params, "projector", tp))
        dt = torch.promote_types(patches.dtype, h.dtype)   # jnp.concatenate
        h = torch.cat([patches.to(dt), h[:, n:].to(dt)], dim=1)
    return _shard_act(h), memory


def forward_logits(cfg: ArchConfig, params, batch, window=None, *,
                   tp=None, zero=None):
    """Full-sequence forward → (logits (B,S,V), aux loss: the MoE's
    load-balance term averaged over layers, 0.0 for the other families).
    ``batch`` holds ``tokens`` (B,S), plus ``frames`` (audio) or
    ``patches`` (vlm).  ``cfg.remat == "full"`` recomputes each block in
    the backward pass (see :func:`_decoder_stack`).  ``tp``: the
    ``models.tp.TP`` to run on (default: the active context's); the
    logits come back whole on every model rank.  ``zero``: a
    ``models.tp.ZeroGather`` when ``params`` are the rank's per-leaf ZeRO
    blocks (the trainer's over data ranks): the top-level leaves are
    gathered once here, each layer's in its block."""
    _require_family(cfg)
    tp = _seq_tp(cfg, tp, batch)
    if window is None:
        window = cfg.sliding_window
    if zero is not None:
        params = zero.top(params)
    h, aux = _final_hidden(cfg, params, batch, window, tp, zero)
    logits = _unembed(cfg, params, h, tp)
    return _shard_act(logits, ("batch", "seq", "vocab")), aux


def _seq_tp(cfg, tp, batch):
    """``tp`` (default: the active context's) for ``batch``'s token
    sequence: in seq mode where the rules split it (``TP.for_seq``)."""
    tp = _tp_of(cfg, tp)
    return None if tp is None else tp.for_seq(batch["tokens"].shape[1])


def _final_hidden(cfg, params, batch, window, tp, zero=None):
    """The final-normed hidden states of the whole sequence (the rank's
    rows of it in seq mode), and aux."""
    tokens = batch["tokens"]
    h, memory = _embed_input(cfg, params, batch, tp, zero)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, aux = _decoder_stack(cfg, params, h, positions, window, memory, tp,
                            zero)
    return _final_norm(cfg, params, h, tp), aux


def loss_fn(cfg: ArchConfig, params, batch, example_weights=None,
            aux_coeff: float = 0.01, window=None, *, tp=None, zero=None):
    """Next-token CE plus ``aux_coeff`` × the MoE aux loss (0 for the other
    families).  ``example_weights`` (B,) carries the AsGrad
    worker-participation mask (see ``distributed.async_trainer``).
    Returns (loss, {"ce", "aux"}).

    Under a data-parallel context (``distributed.sharding.data_context``)
    ``batch`` holds this rank's rows, and every value returned is the
    rank's share: the CE's numerator over its rows divided by the global
    Σ mask (all-reduced over the data group, no gradient), and the MoE's
    aux share (``layers.moe_ffn``).  The shares sum over the ranks to the
    JAX loss on the whole batch, and so do their gradients.

    Under tensor parallelism (``tp``, default the active context's) the
    logits stay split over the vocabulary and the cross entropy is
    vocab-parallel (``layers.vocab_parallel_xent``); every model rank
    returns the same values.

    With ``cfg.remat == "full"`` the backward pass recomputes each
    layer's activations (see :func:`forward_logits`).  ``zero``: the
    params are per-leaf ZeRO blocks, gathered on use (see
    :func:`forward_logits`); the gradients are then the blocks'."""
    from ..distributed.sharding import data_context

    tp = _seq_tp(cfg, tp, batch)
    if tp is None:
        logits, aux = forward_logits(cfg, params, batch, window=window,
                                     zero=zero)
    else:
        if zero is not None:
            params = zero.top(params)
        h, aux = _final_hidden(cfg, params, batch,
                               cfg.sliding_window if window is None
                               else window, tp, zero)
        logits, vp = tp.logits(params, h)
    labels = batch["tokens"][:, 1:]
    lg = logits[:, :-1]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=lg.device)
    if example_weights is not None:
        mask = mask * example_weights[:, None]
    total = None
    ctx = data_context()
    if ctx is not None:
        from ..distributed.collectives import all_reduce
        total = all_reduce(torch.sum(mask), ctx[0])
    ce = L.softmax_xent(lg, labels, mask, mask_total=total) if tp is None \
        else tp.xent(lg, vp, labels, mask, total)
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


def _mamba_with_state(cfg, p, h, convs, ssds, tp=None, split=None):
    """One Mamba2 layer over the prompt; appends its conv state (copied
    out of the layer's full conv input, which is then freed; under ``tp``
    the rank's block of it, ``split["conv"]``) and SSD state."""
    h, (cs, ss) = _apply_mamba(cfg, p, h, return_state=True, tp=tp)
    if tp is not None:
        cs = tp.block(cs, split["conv"])
    convs.append(cs.clone())
    ssds.append(ss)
    return h


def prefill(cfg: ArchConfig, params, batch, ctx_len: Optional[int] = None,
            *, tp=None):
    """Process the prompt, return (last-token logits (B,V), decode cache).

    The cache matches ``cache_specs(cfg, B, ctx_len)``; ctx_len defaults to
    the prompt length.  Only the last position is unembedded.  An SSM or
    hybrid prompt must hold at least ``ssm_conv − 1`` tokens (the conv
    state is the last K−1 pre-conv inputs), and the SSD chunk,
    ``min(ssm_chunk, S)``, must divide its length.  The audio cache's
    ``cross_k`` / ``cross_v`` are each decoder layer's ``memory @ wk`` and
    ``memory @ wv`` over the encoder's output (un-normed, no bias: JAX's
    prefill computes them so), with the frames' length.  ``tp``: the
    ``models.tp.TP`` to run on (default: the active context's); the cache
    is then the rank's block of it.  In seq mode the layers run on the
    rank's rows; k / v, the Mamba2 states and the memory are the whole
    sequence's, and the cache the same as without it."""
    _require_family(cfg)
    tp = _tp_of(cfg, tp)
    whole_tp, tp = tp, _seq_tp(cfg, tp, batch)
    window = cfg.sliding_window
    tokens = batch["tokens"]
    S = tokens.shape[1]
    ctx = ctx_len or S
    W = min(cfg.sliding_window or ctx, ctx)
    h, memory = _embed_input(cfg, params, batch, tp)
    if cfg.family in ("ssm", "hybrid") and S < cfg.ssm_conv - 1:
        raise ValueError(f"an SSM prompt needs at least ssm_conv - 1 = "
                         f"{cfg.ssm_conv - 1} tokens, got {S}")
    split = None if tp is None else tp.cache_split(tokens.shape[0], ctx)
    positions = torch.arange(S, device=tokens.device)
    ks, vs, convs, ssds, cks, cvs = [], [], [], [], [], []

    def mamba(p, x):
        return _mamba_with_state(cfg, p, x, convs, ssds, tp, split)

    def attn(p, x):
        x, (kk, vv) = _apply_attn(cfg, p, x, positions=positions,
                                  window=window, return_kv=True, tp=tp)
        ks.append(kk)
        vs.append(vv)
        return x

    cache = {}
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            h = mamba(_layer(params["blocks"], i)["mamba"], h)
    elif cfg.family == "hybrid":
        g, k, rem = _groups(cfg)
        sa, sm = params["shared_attn"], params["shared_mlp"]
        for i in range(g * k):
            if i % k == 0:
                h = _apply_mlp(cfg, sm, attn(sa, h), tp)
            h = mamba(_layer(params["blocks"]["mamba"], i), h)
        if rem:
            cache["ssm"] = {"conv": torch.stack(convs),
                            "ssd": torch.stack(ssds)}
            convs, ssds = [], []
            for i in range(rem):
                h = mamba(_layer(params["tail"]["mamba"], i), h)
            cache["ssm_tail"] = {"conv": torch.stack(convs),
                                 "ssd": torch.stack(ssds)}
    else:
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"], i)
            h = attn(p["attn"], h)
            if cfg.family == "moe":
                h, _ = _apply_moe(cfg, p["moe"], h, tp)
                continue
            if cfg.family == "audio":
                if tp is None:
                    ck = L.einsum("bsd,dhk->bshk", memory, p["cross"]["wk"])
                    cv = L.einsum("bsd,dhk->bshk", memory, p["cross"]["wv"])
                else:
                    ck, cv = tp.cross_kv(p["cross"], memory, split["cross"])
                cks.append(ck)
                cvs.append(cv)
                h = _apply_attn(cfg, p["cross"], h, kv_h=memory, tp=tp)
            h = _apply_mlp(cfg, p["mlp"], h, tp)
    if convs and "ssm" not in cache:
        cache["ssm"] = {"conv": torch.stack(convs), "ssd": torch.stack(ssds)}
    if ks:
        kc, vc, posbuf = _ring_from_seq(torch.stack(ks), torch.stack(vs), W)
        if tp is not None:
            # k / v hold the rank's kv heads, or all of them: a ring split
            # on ctx keeps the rank's block of the slots
            if split["ring"] == 1:
                kc, vc = tp.block(kc, 2), tp.block(vc, 2)
            posbuf = tp.block(posbuf, split["positions"]).clone()
        cache["self" if cfg.family != "hybrid" else "attn"] = {"k": kc,
                                                               "v": vc}
        cache["positions"] = posbuf
    if cfg.family == "audio":
        cache["cross_k"] = torch.stack(cks)
        cache["cross_v"] = torch.stack(cvs)
    h = h[:, -1:]
    if tp is not None and tp.seq:       # the last rank's last row
        h = tp.gather(h, 1)[:, -1:]
    h = _final_norm(cfg, params, h, whole_tp)
    return _unembed(cfg, params, h, whole_tp)[:, 0], cache


# ============================================================================
# decode (serve_step): lock-step and ragged
# ============================================================================

def cache_specs(cfg: ArchConfig, batch: int, ctx_len: int, *,
                ragged: bool = False) -> dict:
    """Cache tree as Specs: ring k/v caches and one shared (W,) positions
    buffer (dense, vlm, moe; audio adds per-layer cross k/v, declared with
    ``ctx_len`` rows as in the JAX package, where :func:`prefill` emits the
    frames' length), per-layer conv states in the param dtype and f32
    SSD states (ssm, no positions), or both (hybrid: the ring of its g
    insertions, the g·k grouped layers' states flat and the tail's).

    ``ragged=True`` declares the slot server's cache: the positions buffer
    grows a batch axis, (batch, W), so each row tracks its own positions.
    Every other leaf already carries a batch axis and is unchanged."""
    _require_family(cfg)
    W = min(cfg.sliding_window or ctx_len, ctx_len)
    KV, Dh = cfg.n_kv_heads, cfg.d_head
    axes = ("layers", "batch", "ctx", "kv_heads", "head")

    def ring(nl):
        return {"k": Spec((nl, batch, W, KV, Dh), axes, "zeros", cfg.dtype),
                "v": Spec((nl, batch, W, KV, Dh), axes, "zeros", cfg.dtype)}

    def ssm_states(nl):
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        return {
            "conv": Spec((nl, batch, cfg.ssm_conv - 1, conv_dim),
                         ("layers", "batch", None, "d_inner"), "zeros",
                         cfg.dtype),
            "ssd": Spec((nl, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state),
                        ("layers", "batch", "ssm_heads", None, None),
                        "zeros", "float32"),
        }

    positions = (Spec((batch, W), ("batch", "ctx"), "zeros", "int32")
                 if ragged else Spec((W,), ("ctx",), "zeros", "int32"))
    if cfg.family == "ssm":
        return {"ssm": ssm_states(cfg.n_layers)}
    if cfg.family == "hybrid":
        g, k, rem = _groups(cfg)
        c = {"ssm": ssm_states(g * k)}
        if rem:
            c["ssm_tail"] = ssm_states(rem)
        c["attn"] = ring(g)
        c["positions"] = positions
        return c
    c = {"self": ring(cfg.n_layers), "positions": positions}
    if cfg.family == "audio":
        for name in ("cross_k", "cross_v"):
            c[name] = Spec((cfg.n_layers, batch, ctx_len, KV, Dh), axes,
                           "zeros", cfg.dtype)
    return c


def init_cache(cfg: ArchConfig, batch: int, ctx_len: int, device="cuda", *,
               ragged: bool = False, shardings=None) -> dict:
    """An empty cache; with ``shardings`` (``distributed.sharding.
    tree_shardings`` of :func:`cache_specs`) this rank's block of it."""
    tree = init_tree(cache_specs(cfg, batch, ctx_len, ragged=ragged), 0,
                     resolve_device(device), shardings=shardings)
    if "positions" in tree:
        tree["positions"] -= 1             # −1 = empty slot
    return tree


def _decode_cross(cfg, p, h, ck, cv):
    """One-token cross-attention to the cached memory k/v (rank 0 of one
    of ``models.tp.cross_decode_local``)."""
    x = L.rms_norm(h, p["norm"], cfg.norm_eps)
    return h + cross_decode_local(cfg, p, x, ck, cv, 0)


def _decode_mamba(cfg, p, h, conv_state, ssd_state):
    """One-token Mamba2 block → (h', conv state', SSD state')."""
    x_n = L.rms_norm(h, p["norm"], cfg.norm_eps)
    z, xi, Bp, Cp, dt = mamba_project(p, x_n)
    conv_in = torch.cat([xi, Bp, Cp], dim=-1)[:, 0]           # (B, conv_dim)
    y_conv, conv_state = L.conv1d_decode(conv_state, conv_in, p["conv_w"],
                                         p["conv_b"])
    del xi, Bp, Cp                  # read by the conv, not by the SSD step
    dt = mamba_step_dt(p, dt)
    out, ssd_state = mamba_step_local(cfg, p, y_conv, dt, z, ssd_state,
                                      h.dtype)
    return h + out, conv_state, ssd_state


def decode_step(cfg: ArchConfig, params, cache, tokens, pos, ctx_len: int,
                *, tp=None):
    """serve_step: ONE new token per sequence against the cache.

    tokens: (B,) integer tensor; pos: the current absolute position, shared
    by every row (lock-step: an int), or a (B,) integer tensor of per-row
    positions (ragged: the slot server, against a cache made with
    ``ragged=True``).  The SSM family does not read it.  Where the JAX
    package donates the cache, the port updates it in place: the positions
    buffer and each attention layer's ring slot ``pos mod W`` (dense, vlm,
    moe, hybrid, audio), and each Mamba2 layer's conv and SSD states (ssm,
    hybrid), are written, and the same dict is returned; audio's cross k/v
    are read only.  The ragged path reads no
    tensor value on the host, so a CUDA graph can capture it.  ``tp``: the
    ``models.tp.TP`` to run on (default: the active context's), on the
    rank's blocks of the params and the cache: the positions buffer's slot
    is written where the rank holds it, and each rank writes back its
    block of every conv state.  Ragged under ``tp``, each row writes its
    slot ``pos mod W`` where the rank holds it through a mask (a ring
    split on ``ctx``), so that path reads no tensor value on the host
    either.  Returns (logits (B, V), cache)."""
    _require_family(cfg)
    ragged = isinstance(pos, torch.Tensor) and pos.dim() == 1
    tp = _tp_of(cfg, tp)
    if not ragged:
        pos = int(pos)
    split = None if tp is None else tp.cache_split(tokens.shape[0], ctx_len)
    h = _embed(cfg, params, tokens[:, None], tp)        # (B,1,d)
    if "positions" in cache:
        W = min(cfg.sliding_window or ctx_len, ctx_len)
        cpos = cache["positions"]
        rows = cpos_all = None
        if ragged:
            rows = torch.arange(tokens.shape[0], device=tokens.device)
            slot = (pos % W).long()
            if tp is None:
                cpos[rows, slot] = pos.to(cpos.dtype)
            else:
                cpos_all = tp.decode_positions(cpos, pos, slot, split, rows)
        elif tp is not None:
            slot = pos % W
            cpos_all = tp.decode_positions(cpos, pos, slot, split)
        else:
            slot = pos % W
            cpos[slot] = pos

        def attn(p, x, kc, vc):
            """One-token attention; writes this token's k/v into ring slot
            ``slot`` of ``kc`` / ``vc`` in place, then attends."""
            if tp is not None:
                return tp.decode_attn(p, x, kc, vc, cpos, cpos_all, pos,
                                      slot, split, cfg.sliding_window, rows)
            x_n = L.rms_norm(x, p["norm"], cfg.norm_eps)
            return x + decode_local(cfg, p, x_n, kc, vc, cpos, pos, slot,
                                    cfg.sliding_window, rows)

    def mamba(p, x, states, i):
        if tp is None:
            x, states["conv"][i], states["ssd"][i] = _decode_mamba(
                cfg, p, x, states["conv"][i], states["ssd"][i])
        else:
            x, states["conv"][i], states["ssd"][i] = tp.decode_mamba(
                p, x, states["conv"][i], states["ssd"][i], split)
        return x

    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            h = mamba(_layer(params["blocks"], i)["mamba"], h, cache["ssm"], i)
    elif cfg.family == "hybrid":
        g, k, rem = _groups(cfg)
        ring = cache["attn"]
        for i in range(g * k):
            if i % k == 0:
                h = attn(params["shared_attn"], h, ring["k"][i // k],
                         ring["v"][i // k])
                h = _apply_mlp(cfg, params["shared_mlp"], h, tp)
            h = mamba(_layer(params["blocks"]["mamba"], i), h, cache["ssm"], i)
        for i in range(rem):
            h = mamba(_layer(params["tail"]["mamba"], i), h,
                      cache["ssm_tail"], i)
    else:
        ring = cache["self"]
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"], i)
            h = attn(p["attn"], h, ring["k"][i], ring["v"][i])
            if cfg.family == "moe":
                h, _ = _apply_moe(cfg, p["moe"], h, tp)
                continue
            if cfg.family == "audio":
                ck, cv = cache["cross_k"][i], cache["cross_v"][i]
                h = _decode_cross(cfg, p["cross"], h, ck, cv) if tp is None \
                    else tp.decode_cross(p["cross"], h, ck, cv,
                                         split["cross"])
            h = _apply_mlp(cfg, p["mlp"], h, tp)
    h = _final_norm(cfg, params, h, tp)
    return _unembed(cfg, params, h, tp)[:, 0], cache


# ============================================================================
# batch specs
# ============================================================================

def batch_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """Train/prefill batch as Specs: int32 tokens (B, seq); audio: f32
    frames (B, seq, frontend_dim) and tokens (B, max(seq // dec_ratio,
    8)); vlm: tokens and f32 patches (B, min(n_patches, max(seq // 4, 4)),
    vision_dim).  The stubbed modality inputs have the "normal" law."""
    _require_family(cfg)
    s: dict = {}
    if cfg.family == "audio":
        s["frames"] = Spec((batch, seq, cfg.frontend_dim),
                           ("batch", "seq", None), "normal", "float32")
        s["tokens"] = Spec((batch, max(seq // cfg.dec_ratio, 8)),
                           ("batch", "seq"), "zeros", "int32")
        return s
    s["tokens"] = Spec((batch, seq), ("batch", "seq"), "zeros", "int32")
    if cfg.family == "vlm":
        npatch = min(cfg.n_patches, max(seq // 4, 4))
        s["patches"] = Spec((batch, npatch, cfg.vision_dim),
                            ("batch", "seq", None), "normal", "float32")
    return s
