"""Tensor parallelism over the mesh's model axis, for all six families.

The JAX package shards over the model axis by layout alone: every leaf
carries the ``PartitionSpec`` of ``logical_pspec`` and GSPMD inserts the
collectives.  The port computes the same function with explicit tensor
parallelism over the model group.  Each rank holds exactly the block of
every param and cache leaf that ``distributed.sharding.logical_pspec``
gives it (:func:`plan` and :func:`cache_split` read those splits), and the
layers compute Megatron-style where the rules' split is a Megatron split:

* attention on each rank's heads when the rules split ``wq`` / ``wo`` on
  ``heads``: q column-split, k and v on the rank's kv heads (split on
  ``kv_heads``, or projected whole and the rank's kv heads taken), ``wo``
  row-split, the output summed over the ranks; the same for the audio
  encoder's bidirectional attention and the decoder's cross-attention,
  whose k and v come from the encoder memory (the ``cross_k`` /
  ``cross_v`` cache on the rank's kv heads);
* the MLP column-split on ``ff`` (``w_gate``, ``w_up``) and row-split
  (``w_down``);
* the experts expert-parallel on ``experts``: the routing replicated, each
  rank running its E/M experts, the combine summed over the ranks
  (``layers.moe_ffn``);
* the Mamba2 mixer on each rank's SSM heads when the rules split
  ``d_inner`` and ``ssm_heads`` (:data:`MAMBA_MEGATRON`): ``in_z`` /
  ``in_x`` column-split on ``d_inner``, ``in_dt``, ``A_log``, ``D`` and
  ``dt_bias`` on the rank's heads, the SSD scan on them (the kernel on
  the rank-local shape), the gated norm over the whole ``d_inner`` with
  each rank's Σy² all-reduced (``layers.gated_rms_norm``), ``out_proj``
  row-split and its output summed; ``in_B`` / ``in_C`` (``state`` wants
  no model axis) whole on every rank, and so is their compute;
* a vocab-parallel embedding and unembedding on ``vocab``, with the
  vocab-parallel cross entropy (``layers.vocab_parallel_xent``).

Where the rules pick another dim (a norm weight on ``embed``, the router
on ``experts``, ``frontend_proj`` / ``projector`` on ``embed``, qwen2-0.5b's
attention at a model axis its 14 heads do not divide, seamless's
unembedding where its 256206 words do not divide), the leaf is gathered on
use over the model group and the compute through it is replicated.
``conv_w`` / ``conv_b`` are split contiguously over ``[x, B, C]``, which
does not line up with the heads: they are gathered on use and each rank
takes its x columns and all of B and C (:func:`conv_columns`); their
gradient reduce-scatters (the x columns are one rank's, the B / C ones
partial sums over the ranks' heads).  ``distributed.collectives`` holds
the operators and the rule for a gathered leaf's gradient.

The rank-local parts (:func:`attn_local`, :func:`decode_local`,
:func:`cross_decode_local`, :func:`embed_local`, :func:`kv_for_heads`,
:func:`mamba_local`, :func:`mamba_step_local`, and the layers'
``moe_ffn`` / ``swiglu`` / ``vocab_parallel_xent`` on blocks) run no
collective: :class:`TP` runs them between its collectives, and the
unsharded model runs the same attention and Mamba2 parts as rank 0 of
one.  :class:`ThreadRanks` runs
the ranks as threads of one process whose group's collectives combine the
ranks' tensors themselves, so the decomposition (and, with autograd on,
its backward) can be checked on one device through the product path's
own layers and operators.

Decode: a ring cache the rules split on ``kv_heads`` decodes on each
rank's heads; one split on ``ctx`` (qwen2-0.5b at model 4: two kv heads)
runs every head over the rank's block of the slots, with the
distributed softmax of ``layers.decode_attention_ctx``.  The ragged
decode (the slot lane: a position per row) does the same per row: where
the ring is split on ``ctx``, each row writes its k/v and position
through a mask where the rank holds its slot, so no value is read on the
host.  The SSD state is
split on ``ssm_heads``, in line with the heads; the conv state, split
like ``conv_w``, is gathered, shifted by the new column (the rank's x
columns gathered), and the rank writes its block of it back, so each rank
holds the rules' block after every step.  The logits of prefill and
decode are gathered whole over the vocabulary, so a greedy pick is the
first maximal index of the whole row on every rank.

Sequence parallelism (rules that give ``seq`` the model axis, as
``distributed.sharding.SEQ_PARALLEL_RULES``; :meth:`TP.for_seq`): where the
rules split the residual of S rows on ``seq`` (S a multiple of the model
axis M), each rank holds its block of S/M rows between blocks, from row
``lo`` = rank · S/M on.  Norms and token-wise compute run on the rank's
rows; where a block runs on the rank's heads, ff columns, experts, SSM
heads or vocabulary block, the copy before it becomes a gather of the
rows (``collectives.gather_seq``) and the reduce after it a
reduce-scatter to the rank's rows (``collectives.scatter_seq``).  Where
the attention leaves are gathered (qwen2-0.5b at model 4), each rank
computes q for its own rows and k / v from the gathered sequence, and
attends with its rows' first position as the masks' offset (flash at
``q_offset``), with no reduce after.  The MoE gathers the rows before
the dispatch, so its capacity couples the rows it couples unsharded; the
Mamba2 mixer and the audio encoder's memory run on the gathered
sequence; the vocab-parallel embedding ends in a reduce-scatter, and the
logits see the gathered rows.  Decode (one row) and a length the axis
does not divide keep the whole sequence, as JAX's layout does.  Every
leaf a rank reads on its rows gives it a part of the leaf's gradient, so
such a read is rank-partial (``whole(..., partial=True)``).
"""
from __future__ import annotations

import copy
import functools
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers as L
from .specs import torch_dtype

F32 = torch.float32

#: the dim of each attention leaf (per layer) that a Megatron split takes
ATTN_MEGATRON = {"wq": 1, "bq": 0, "wo": 0, "wk": 1, "wv": 1, "bk": 0,
                 "bv": 0}
#: the dim of each Mamba2 leaf (per layer) that a split on the rank's SSM
#: heads takes: the d_inner columns of z's and x's projections and of the
#: gate norm, the d_inner rows of ``out_proj``, the heads of dt's
#: projection and of A, D and dt's bias
MAMBA_MEGATRON = {"in_z": 1, "in_x": 1, "in_dt": 1, "A_log": 0, "D": 0,
                  "dt_bias": 0, "gate_norm": 0, "out_proj": 0}
#: the param subtrees stacked over layers (a leaf's ``layers`` dim dropped)
STACKED = ("blocks", "enc_blocks", "tail")


def _split_dim(spec, mesh, rules) -> Optional[int]:
    from ..distributed.sharding import logical_pspec

    ps = logical_pspec(spec.axes, spec.shape, mesh, rules)
    return next((i for i, e in enumerate(ps) if e == rules.model_axis),
                None)


@functools.lru_cache(maxsize=64)
def plan(cfg, M: int, rules=None) -> dict:
    """The model-axis split dim of every param leaf of ``cfg`` at a model
    axis of ``M`` (None: whole on every rank), per layer: a stacked
    leaf's ``layers`` dim is dropped.  Keyed by the kind of block, each
    kind's layers having one shape: ``{"embed", "final_norm", "lm_head",
    "attn", "mlp", "moe", "mamba", "cross", ...}`` (the hybrid's
    ``shared_attn`` / ``shared_mlp`` and the audio encoder's blocks under
    ``attn`` / ``mlp``, the hybrid's tail under ``mamba``), plus the
    unstacked leaves by name (``frontend_proj``, ``enc_norm``,
    ``projector``)."""
    from ..distributed.sharding import DEFAULT_RULES
    from ..launch.mesh import Mesh

    rules = rules or DEFAULT_RULES
    mesh = Mesh({rules.model_axis: M})
    return by_kind(cfg, lambda s: _split_dim(s, mesh, rules))


def by_kind(cfg, dim_of) -> dict:
    """``dim_of(spec)`` (a dim of the whole leaf, or None) over ``cfg``'s
    param leaves, per layer and keyed by the kind of block as
    :func:`plan` is."""
    from .model import param_specs

    def walk(tree, stacked):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, stacked)
            else:
                d = dim_of(v)
                out[k] = d - 1 if stacked and d is not None else d
        return out

    out = {}
    for k, v in param_specs(cfg).items():
        if k in STACKED:
            out.update(walk(v, True))
        elif k.startswith("shared_"):
            out[k[len("shared_"):]] = walk(v, False)
        else:
            out.update(walk({k: v}, False))
    return out


def _data_dim(spec, mesh, rules) -> Optional[int]:
    from ..distributed.sharding import data_dim, logical_pspec, zero_pspec

    ps = logical_pspec(spec.axes, spec.shape, mesh, rules)
    return data_dim(zero_pspec(spec.axes, spec.shape, mesh, ps, rules),
                    mesh, rules)


class ZeroGather:
    """Per-leaf ZeRO on the model's side.  The trainer hands the model
    each param leaf as this rank's ZeRO block of its model block (the
    leaf's ``tree_shardings(..., zero=True)`` layout); ``take`` gathers a
    layer's blocks over the data group, on the dim
    ``distributed.sharding.data_dim`` names, into the model blocks
    :class:`TP` computes on (``collectives.gather_blocks``: the backward
    reduce-scatters each gradient into the block, in its dtype).  ``plan``
    holds those dims per layer and keyed by the kind of block, as
    :func:`plan` does.
    The group and the dims are held here, so a gather repeated in a
    recomputed block or run in a backward on another thread reads no
    context.  Made only where some leaf is split over more than one data
    rank (:meth:`of`)."""

    def __init__(self, cfg, mesh, rules=None):
        from ..distributed.sharding import DEFAULT_RULES, pool_axes

        rules = rules or DEFAULT_RULES
        self.group = mesh.group(pool_axes(mesh, rules))
        self.plan = by_kind(cfg, lambda s: _data_dim(s, mesh, rules))

    @classmethod
    def of(cls, cfg, mesh, rules=None):
        """The gather of ``cfg``'s params on ``mesh``, or None where no
        leaf is split over more than one data rank (no mesh, data 1)."""
        from ..distributed.sharding import DEFAULT_RULES, pool_axes

        if mesh is None or \
                mesh.count(pool_axes(mesh, rules or DEFAULT_RULES)) == 1:
            return None
        return cls(cfg, mesh, rules)

    def _gather(self, t, dims):
        from ..distributed.collectives import gather_blocks

        if isinstance(t, dict):
            return {k: self._gather(v, dims[k]) for k, v in t.items()}
        return t if dims is None else gather_blocks(t, self.group, dims)

    def take(self, p, kind: str):
        """``p`` (one layer of block kind ``kind``, or the top-level leaf
        named ``kind``) gathered over the data group."""
        return self._gather(p, self.plan[kind])

    def layer(self, p: dict) -> dict:
        """One layer's slice of a stacked subtree (``{kind: leaves}``)
        gathered."""
        return {k: self.take(v, k) for k, v in p.items()}

    def top(self, params: dict) -> dict:
        """``params`` with every top-level leaf gathered (read once per
        forward); the layer subtrees are left as blocks."""
        return {k: v if isinstance(v, dict) else self.take(v, k)
                for k, v in params.items()}


def cache_split(cfg, M: int, batch: int, ctx_len: int, rules=None) -> dict:
    """The model-axis split dim of the lock-step cache's leaves, per
    layer, for those the family's cache holds: the ring ``{"ring": 2
    (kv_heads) | 1 (ctx) | None, "positions": 0 | None}``, the audio
    cross k/v (``"cross"``, as the ring), the Mamba2 states (``"conv"``:
    2, its ``[x, B, C]`` columns, or None; ``"ssd"``: 1, the SSM heads, or
    None)."""
    from ..distributed.sharding import DEFAULT_RULES
    from ..launch.mesh import Mesh
    from .model import cache_specs

    rules = rules or DEFAULT_RULES
    mesh = Mesh({rules.model_axis: M})
    specs = cache_specs(cfg, batch, ctx_len)

    def layer(spec):
        d = _split_dim(spec, mesh, rules)
        return None if d is None else d - 1

    out = {}
    ring = specs.get("self", specs.get("attn"))
    if ring is not None:
        out["ring"] = layer(ring["k"])
        out["positions"] = _split_dim(specs["positions"], mesh, rules)
    if "cross_k" in specs:
        out["cross"] = layer(specs["cross_k"])
    if "ssm" in specs:
        out["conv"] = layer(specs["ssm"]["conv"])
        out["ssd"] = layer(specs["ssm"]["ssd"])
    return out


# ---------------------------------------------------------------------------
# rank-local parts: no collective
# ---------------------------------------------------------------------------

def embed_local(table, tokens, rank: int):
    """A rank's part of the embedding lookup on its block of the vocabulary
    rows (``table``): a token of another block gives zeros."""
    n = table.shape[0]
    t = tokens - rank * n
    mine = (t >= 0) & (t < n)
    return torch.where(mine[..., None], table[t.clamp(0, n - 1)], 0)


def kv_for_heads(k, n_heads: int, n_kv: int, hq: int, rank: int):
    """The kv heads the rank's ``hq`` query heads read, from ``k``: ``k``
    itself when it holds as many heads as the rank's share (or all of them
    for all the query heads), else the rank's kv heads of the whole ``k``
    (contiguous when one divides the other; one per query head
    otherwise)."""
    G = n_heads // n_kv
    if k.shape[2] * G == hq:
        return k
    q0 = rank * hq
    if hq % G == 0 or G % hq == 0:
        lo = q0 // G
        return k[:, :, lo:lo + max(hq // G, 1)]
    idx = (q0 + torch.arange(hq, device=k.device)) // G
    return k.index_select(2, idx)


def project_qkv(cfg, p, x, src=None):
    """q from the normed input ``x``; k and v from ``src`` (a
    cross-attention memory) or, without one, from ``x``; through the
    rank's attention leaves ``p`` (its blocks where the split is
    Megatron's, whole otherwise), with the bias and the QK-norm."""
    src = x if src is None else src
    q = L.einsum("bsd,dhk->bshk", x, p["wq"])
    k = L.einsum("bsd,dhk->bshk", src, p["wk"])
    v = L.einsum("bsd,dhk->bshk", src, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attn_local(cfg, p, x, rank: int, *, positions=None, window=None,
               causal: bool = True, src=None, kv_x=None, q_offset: int = 0):
    """A rank's attention over the sequence → (out, k, v): ``out`` is its
    part of the block's output (B, S, d), to be summed over the ranks when
    ``wq`` / ``wo`` are split on heads (else the whole output), and ``k``
    / ``v`` as projected (the rank's kv heads, or all of them), for the
    cache.  ``src``: a cross-attention memory, the source of k and v (no
    RoPE, never causal); otherwise self-attention, with RoPE at
    ``positions`` when they are given.  ``kv_x``: self-attention whose
    queries are a block of rows from ``q_offset`` (``x``, a rank's rows
    under sequence parallelism) of the sequence ``kv_x``, the source of k
    and v; ``positions`` are then ``kv_x``'s, and the masks put the
    queries at their absolute positions.  Flash runs on the rank's heads
    when ``use_flash_attention``.  With no model axis this is the whole
    attention (rank 0 of one)."""
    q, k, v = project_qkv(cfg, p, x, src if src is not None else kv_x)
    if src is None and positions is not None:
        qpos = positions if kv_x is None else \
            positions[q_offset:q_offset + x.shape[1]]
        q = L.rope(q, qpos, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    causal = causal and src is None
    hq = q.shape[2]
    ks = kv_for_heads(k, cfg.n_heads, cfg.n_kv_heads, hq, rank)
    vs = kv_for_heads(v, cfg.n_heads, cfg.n_kv_heads, hq, rank)
    if cfg.use_flash_attention:
        o = ops.flash_attention(q, ks, vs, causal=causal, window=window,
                                q_offset=q_offset)
    else:
        o = L.attention(q, ks, vs, causal=causal, window=window,
                        q_offset=q_offset)
    return L.einsum("bshk,hkd->bsd", o, p["wo"]), k, v


def decode_qkv(cfg, p, x, pos, ragged: bool = False):
    """q, k, v of one token (the normed ``x``, (B, 1, d)) with RoPE at
    ``pos``: an int (lock-step), or a (B,) tensor of per-row positions
    (``ragged``)."""
    q, k, v = project_qkv(cfg, p, x)
    posv = pos[:, None] if ragged else torch.full((1,), pos,
                                                  device=x.device)
    return L.rope(q, posv, cfg.rope_theta), L.rope(k, posv, cfg.rope_theta), v


def decode_local(cfg, p, x, kc, vc, cache_positions, pos, slot, window,
                 rows=None):
    """One-token attention of the normed ``x`` through the rank's
    attention leaves ``p``, against the ring ``kc`` / ``vc`` of the same
    heads → its part of the block's output (B, 1, d).  Writes the token's
    k/v into ring slot ``slot`` in place first.  Lock-step: ``pos`` and
    ``slot`` are ints.  Ragged: they are (B,) tensors and ``rows`` is
    ``arange(B)``, so each row writes its own slot."""
    q, k, v = decode_qkv(cfg, p, x, pos, ragged=rows is not None)
    if rows is not None:
        kc[rows, slot] = k[:, 0]
        vc[rows, slot] = v[:, 0]
    else:
        kc[:, slot] = k[:, 0]
        vc[:, slot] = v[:, 0]
    o = L.decode_attention(q, kc, vc, cache_positions, pos, window=window)
    return L.einsum("bshk,hkd->bsd", o, p["wo"])


def cross_decode_local(cfg, p, x, ck, cv, rank: int):
    """One-token cross-attention of the normed ``x`` through the rank's
    ``wq`` / ``wo`` (its heads, or all of them) to the cached memory k/v
    of the same heads (or all of them) → its part of the block's output
    (B, 1, d); no bias, no QK-norm, no RoPE on q, as in the JAX
    package."""
    q = L.einsum("bsd,dhk->bshk", x, p["wq"])
    hq = q.shape[2]
    o = L.attention(q, kv_for_heads(ck, cfg.n_heads, cfg.n_kv_heads, hq,
                                    rank),
                    kv_for_heads(cv, cfg.n_heads, cfg.n_kv_heads, hq, rank),
                    causal=False)
    return L.einsum("bshk,hkd->bsd", o, p["wo"])


def mamba_project(p, x):
    """Projections of the normed input ``x`` (B, S, d) through the rank's
    Mamba2 leaves ``p`` → (z, x, B, C, dt): z, x and dt on the rank's
    columns and heads, B and C whole."""
    z = L.einsum("bsd,de->bse", x, p["in_z"])
    xi = L.einsum("bsd,de->bse", x, p["in_x"])
    Bp = L.einsum("bsd,dn->bsn", x, p["in_B"])
    Cp = L.einsum("bsd,dn->bsn", x, p["in_C"])
    dt = L.einsum("bsd,dh->bsh", x, p["in_dt"])
    return z, xi, Bp, Cp, dt


def conv_columns(t, d_inner: int, rank: int, n: int):
    """The columns of a whole conv leaf or state (last dim ``[x, B, C]``,
    ``d_inner`` x columns) that a rank's heads read: its ``n`` x columns
    from ``rank · n`` on, then all of B and C."""
    return torch.cat([t[..., rank * n:(rank + 1) * n], t[..., d_inner:]],
                     dim=-1)


def mamba_local(cfg, p, x, conv_w, conv_b, sumsq=None):
    """A rank's Mamba2 mixer over the sequence on its SSM heads → (out,
    conv input, final SSD state): ``out`` (B, S, d) is its part of the
    block's output, to be summed over the ranks when the heads are split
    (else the whole output); the conv input is its pre-conv ``[x, B, C]``
    columns (the decode's conv state comes from their last K−1 rows); the
    SSD state is its heads'.  ``p`` holds the rank's leaves (the whole
    ``in_B`` / ``in_C``), ``conv_w`` / ``conv_b`` the conv columns it reads
    (:func:`conv_columns`), ``sumsq`` sums the gated norm's squares over
    the ranks (None: the whole ``d_inner`` is here).  The SSD scan runs
    the kernel on the rank's heads with ``use_ssd_kernel``.  With no model
    axis this is the whole mixer (rank 0 of one)."""
    B, S, _ = x.shape
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    z, xi, Bp, Cp, dt = mamba_project(p, x)
    dl = xi.shape[-1]
    conv_in = torch.cat([xi, Bp, Cp], dim=-1)
    conv_out = L.causal_conv1d(conv_in, conv_w, conv_b)
    xi, Bp, Cp = torch.split(conv_out, [dl, N, N], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, S, dl // P, P)
    y, hT = L.ssd_chunked(xh, dt, A, Bp, Cp, chunk=min(cfg.ssm_chunk, S),
                          use_kernel=cfg.use_ssd_kernel)
    y = y + xh.to(F32) * p["D"][None, None, :, None]
    y = L.gated_rms_norm(y.reshape(B, S, dl).to(x.dtype), z, p["gate_norm"],
                         cfg.norm_eps, sumsq, cfg.d_inner)
    return L.einsum("bse,ed->bsd", y, p["out_proj"]), conv_in, hT


def mamba_step_dt(p, dt):
    """The one-token step sizes of dt's projection (B, 1, heads):
    softplus(dt + dt_bias) in f32, (B, heads)."""
    return F.softplus(dt[:, 0].to(F32) + p["dt_bias"])


def mamba_step_local(cfg, p, y_conv, dt, z, ssd_state, dtype, sumsq=None):
    """A rank's one-token SSD step on its heads and its gated output, from
    its columns of the conv output ``y_conv`` (B, x columns + 2N) → (its
    part of the block's output (B, 1, d), the SSD state′); ``dt``
    (:func:`mamba_step_dt`) and ``z`` are its heads' and columns' of the
    token, ``ssd_state`` its heads' (B, H/M, P, N), ``dtype`` the
    activations'; ``sumsq`` as in :func:`mamba_local`."""
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    B = y_conv.shape[0]
    dl = y_conv.shape[-1] - 2 * N
    xi, Bp, Cp = torch.split(y_conv, [dl, N, N], dim=-1)
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, dl // P, P)
    y, ssd_state = L.ssd_decode_step(ssd_state, xh, dt, A, Bp, Cp)
    y = y + xh.to(F32) * p["D"][None, :, None]
    y = L.gated_rms_norm(y.reshape(B, 1, dl).to(dtype), z, p["gate_norm"],
                         cfg.norm_eps, sumsq, cfg.d_inner)
    return L.einsum("bse,ed->bsd", y, p["out_proj"]), ssd_state


# ---------------------------------------------------------------------------
# the product path: the rank-local parts between the collectives
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def _seq_on(M: int, rules, S: int, d_model: int) -> bool:
    from ..distributed.sharding import residual_seq_split
    from ..launch.mesh import Mesh

    return residual_seq_split(Mesh({rules.model_axis: M}), rules, S, d_model)


class TP:
    """A model group (the active context's, ``distributed.sharding.
    model_context``) and ``cfg``'s :func:`plan` on it.  The model's entry
    points take one (``tp=``) or resolve the active context's once a call
    (:meth:`active`), and hand it down to every layer; an entry point over
    a sequence hands down :meth:`for_seq`'s, which is in seq mode
    (``seq``: the rank holds rows ``lo`` … ``lo + rows − 1`` of the
    residual) where the rules split the sequence."""

    seq = False
    rows = None
    lo = 0

    def __init__(self, cfg, group, M: int, rank: int, rules):
        self.cfg, self.group, self.M, self.rank = cfg, group, M, rank
        self.rules = rules
        self.plan = plan(cfg, M, rules)

    def for_seq(self, S: int) -> "TP":
        """This TP for a sequence of ``S`` rows: in seq mode where the
        rules split the residual on ``seq`` over the model axis
        (``distributed.sharding.residual_seq_split``), whole otherwise."""
        from ..distributed.sharding import DEFAULT_RULES

        on = _seq_on(self.M, self.rules or DEFAULT_RULES, S,
                     self.cfg.d_model)
        if not on and not self.seq:
            return self
        t = copy.copy(self)
        t.seq = on
        t.rows = S // self.M if on else None
        t.lo = self.rank * t.rows if on else 0
        return t

    @classmethod
    def active(cls, cfg) -> Optional["TP"]:
        """The TP of the active context, or None (no context, or a model
        axis of 1); a family outside ``sharding.TP_FAMILIES`` (every
        family of the registry is in it) raises ``NotImplementedError``."""
        from ..distributed import sharding as sh

        M = sh.model_axis_size()
        if M == 1:
            return None
        if cfg.family not in sh.TP_FAMILIES:
            raise NotImplementedError(sh.model_axis_waits(cfg.family, M))
        group, M, rank = sh.model_context()
        return cls(cfg, group, M, rank, sh.active_rules())

    # ---- operators --------------------------------------------------------
    def copy(self, t):
        from ..distributed.collectives import copy_to_model
        return copy_to_model(t, self.group)

    def reduce(self, t):
        from ..distributed.collectives import reduce_from_model
        return reduce_from_model(t, self.group)

    def amax(self, t):
        from ..distributed.collectives import all_reduce
        return all_reduce(t, self.group, "max")

    def gather(self, t, dim: int):
        """The ranks' ``t`` concatenated along ``dim`` (no gradient)."""
        from ..distributed.collectives import all_gather
        return all_gather(t, self.group, dim % t.dim())

    def whole(self, t, dim: Optional[int], partial: bool = False):
        """Leaf ``t`` whole: gathered over the model group when the rules
        split it on ``dim``; ``partial`` when a rank-partial region reads
        it (see ``distributed.collectives``)."""
        from ..distributed.collectives import gather_from_model
        if dim is None:
            return self.copy(t) if partial else t
        return gather_from_model(t, self.group, dim, self.rank, partial)

    # ---- sequence-parallel operators (seq mode) ---------------------------
    def gather_seq(self, t, partial: bool = True):
        """The ranks' rows of ``t`` gathered into the whole sequence;
        ``partial``: a rank-partial consumer (the backward reduce-scatters)
        or a replicated one (it keeps the rank's rows)."""
        from ..distributed.collectives import gather_seq
        return gather_seq(t, self.group, 1, self.rank, partial)

    def scatter_seq(self, t):
        """Σ over the ranks of their parts of a whole sequence, the rank's
        rows of it."""
        from ..distributed.collectives import scatter_seq
        return scatter_seq(t, self.group, 1)

    def split_seq(self, t):
        """The rank's rows of a whole sequence every rank holds the same."""
        from ..distributed.collectives import split_seq
        return split_seq(t, self.group, 1, self.rank, self.M)

    def rows_of(self, t):
        """The rank's rows of an input ``t`` (tokens, frames: no
        gradient)."""
        return t[:, self.lo:self.lo + self.rows]

    # ---- layers -----------------------------------------------------------
    def _norm(self, h, w, dim):
        """RMSNorm of ``h`` (on the rank's rows in seq mode, where each
        rank gives a part of the weight's gradient)."""
        return L.rms_norm(h, self.whole(w, dim, partial=self.seq),
                          self.cfg.norm_eps)

    def _attn_leaves(self, p, heads: bool) -> dict:
        pl = self.plan["attn"]
        return {n: t if heads and pl[n] is not None
                and pl[n] == ATTN_MEGATRON.get(n)
                else self.whole(t, pl[n], partial=heads)
                for n, t in p.items() if n != "norm"}

    def heads_split(self) -> bool:
        return self.plan["attn"]["wq"] == ATTN_MEGATRON["wq"]

    def leaf(self, params, name: str):
        """Top-level leaf ``name`` whole (gathered where it is split); in
        seq mode it is read on the rank's rows (rank-partial)."""
        return self.whole(params[name], self.plan[name], partial=self.seq)

    def attn(self, p, h, *, positions=None, window=None, return_kv=False,
             causal: bool = True, src=None):
        """Pre-norm attention on the rank's heads (or whole); ``src``: a
        cross-attention memory, the source of k and v (every rank's
        whole), as in ``attn_local``.  In seq mode ``h`` is the rank's
        rows, and so is the output; k and v are the whole sequence's."""
        x = self._norm(h, p["norm"], self.plan["attn"]["norm"])
        heads = self.heads_split()
        if self.seq:
            out, k, v = self._attn_rows(p, x, heads, positions, window,
                                        causal, src)
            out = h + out
            return (out, (k, v)) if return_kv else out
        if heads:
            x = self.copy(x)
            src = None if src is None else self.copy(src)
        out, k, v = attn_local(self.cfg, self._attn_leaves(p, heads), x,
                               self.rank, positions=positions, window=window,
                               causal=causal, src=src)
        out = h + (self.reduce(out) if heads else out)
        return (out, (k, v)) if return_kv else out

    def _attn_rows(self, p, x, heads, positions, window, causal, src):
        """Seq mode's attention of the rank's normed rows ``x`` → (the
        block's output on them, k, v): on the rank's heads over the
        gathered rows, scattered back; or, where the leaves are gathered,
        q of the rank's rows against k / v of the gathered sequence, at
        the rows' offset."""
        src = None if src is None else self.copy(src)
        if heads:
            out, k, v = attn_local(
                self.cfg, self._attn_leaves(p, True), self.gather_seq(x),
                self.rank, positions=positions, window=window, causal=causal,
                src=src)
            return self.scatter_seq(out), k, v
        pl = self.plan["attn"]
        lp = {n: self.whole(t, pl[n], partial=True) for n, t in p.items()
              if n != "norm"}
        return attn_local(self.cfg, lp, x, 0, positions=positions,
                          window=window, causal=causal, src=src,
                          kv_x=None if src is not None
                          else self.gather_seq(x), q_offset=self.lo)

    def _swiglu(self, p, pl, x, rows: bool = False):
        """(rank part, whole part) of a SwiGLU: the first when it is
        split on ``ff``.  ``rows``: ``x`` is the rank's rows (seq mode),
        gathered into the rank's columns or computed on the rows."""
        names = ("w_gate", "w_up", "w_down")
        if pl["w_gate"] == p["w_gate"].dim() - 1:
            return L.swiglu(self.gather_seq(x) if rows else self.copy(x),
                            *(p[n] for n in names)), None
        return None, L.swiglu(x, *(self.whole(p[n], pl[n], partial=rows)
                                   for n in names))

    @staticmethod
    def _sum(*ts):
        ts = [t for t in ts if t is not None]
        return ts[0] if len(ts) == 1 else sum(ts[1:], ts[0])

    def mlp(self, p, h):
        pl = self.plan["mlp"]
        x = self._norm(h, p["norm"], pl["norm"])
        part, whole = self._swiglu(p, pl, x, rows=self.seq)
        if part is not None:
            part = self.scatter_seq(part) if self.seq else self.reduce(part)
        return h + self._sum(part, whole)

    def moe(self, p, h):
        """The MoE block; in seq mode the rank's rows are gathered before
        the dispatch (the routing replicated over the whole sequence, as
        without seq mode) and the output returns to the rank's rows."""
        cfg, pl = self.cfg, self.plan["moe"]
        x = self._norm(h, p["norm"], pl["norm"])
        if self.seq:
            x = self.gather_seq(x, partial=False)
        router = self.whole(p["router"], pl["router"])
        names = ("w_gate", "w_up", "w_down")
        parts, wholes = [], []
        if pl["w_gate"] == 0:
            el = p["w_gate"].shape[0]
            y, aux = L.moe_ffn(x, router, *(p[n] for n in names), cfg.top_k,
                               cfg.capacity_factor,
                               first_expert=self.rank * el, enter=self.copy)
            parts.append(y)
        else:
            y, aux = L.moe_ffn(x, router, *(self.whole(p[n], pl[n])
                                            for n in names),
                               cfg.top_k, cfg.capacity_factor)
            wholes.append(y)
        if "shared" in p:
            part, whole = self._swiglu(p["shared"], pl["shared"], x)
            parts.append(part)
            wholes.append(whole)
        parts = [t for t in parts if t is not None]
        if self.seq:
            wholes = [t for t in wholes if t is not None]
            y = self._sum(self.scatter_seq(self._sum(*parts)) if parts
                          else None,
                          self.split_seq(self._sum(*wholes)) if wholes
                          else None)
            return h + y, aux
        y = self._sum(self.reduce(self._sum(*parts)) if parts else None,
                      *wholes)
        return h + y, aux

    def embed(self, table, tokens):
        """The embedding of ``tokens`` (B, S); in seq mode the rank's
        rows of it."""
        d, dt = self.plan["embed"], torch_dtype(self.cfg.dtype)
        if d == 0:
            part = embed_local(table, tokens, self.rank).to(dt)
            return self.scatter_seq(part) if self.seq else self.reduce(part)
        if self.seq:
            tokens = self.rows_of(tokens)
        return self.whole(table, d, partial=self.seq)[tokens].to(dt)

    def logits(self, params, h):
        """→ (logits, vocab-parallel): the rank's block of the vocabulary
        when the unembedding is split on ``vocab``, else the whole; in
        seq mode of every row (the rank's rows ``h`` gathered)."""
        if self.cfg.tie_embeddings:
            t, d, eq, vdim = params["embed"], self.plan["embed"], \
                "bsd,vd->bsv", 0
        else:
            t, d, eq, vdim = params["lm_head"], self.plan["lm_head"], \
                "bsd,dv->bsv", 1
        if self.seq:
            h = self.gather_seq(h, partial=d == vdim)
        if d == vdim:
            return L.einsum(eq, h if self.seq else self.copy(h), t), True
        return L.einsum(eq, h, self.whole(t, d)), False

    def full_logits(self, params, h):
        """The logits whole on every rank (gathered over the vocabulary)."""
        lg, vp = self.logits(params, h)
        return self.whole(lg, lg.dim() - 1) if vp else lg

    def xent(self, lg, vp: bool, labels, mask, total):
        if not vp:
            return L.softmax_xent(lg, labels, mask, mask_total=total)
        return L.vocab_parallel_xent(lg, labels, mask, mask_total=total,
                                     first=self.rank * lg.shape[-1],
                                     amax=self.amax, total=self.reduce)

    def mamba_heads(self) -> bool:
        """Whether the rules split the Mamba2 mixer on the SSM heads (every
        leaf of :data:`MAMBA_MEGATRON` on its dim there)."""
        pl = self.plan["mamba"]
        return all(pl[n] == d for n, d in MAMBA_MEGATRON.items())

    def _mamba_leaves(self, p, heads: bool) -> dict:
        """The mixer's leaves but the norm and the conv: the rank's blocks
        and the whole ``in_B`` / ``in_C`` (rank-partial compute reads
        them) on the heads, else every leaf whole."""
        pl = self.plan["mamba"]
        if not heads:
            return {n: self.whole(t, pl[n]) for n, t in p.items()
                    if n not in ("norm", "conv_w", "conv_b")}
        lp = {n: p[n] for n in MAMBA_MEGATRON}
        for n in ("in_B", "in_C"):
            lp[n] = self.whole(p[n], pl[n], partial=True)
        return lp

    def _sumsq(self, t):
        """Σ over the ranks of their parts of the gated norm's squares, in
        the forward and (every rank's part of the gradient) the
        backward."""
        return self.reduce(self.copy(t))

    def mamba(self, p, h, return_state: bool = False):
        """The Mamba2 block on the rank's SSM heads (or whole); with
        ``return_state`` also (the whole conv state: the last K−1 pre-conv
        inputs, the final SSD state of the rank's heads)."""
        cfg, pl = self.cfg, self.plan["mamba"]
        heads = self.mamba_heads()
        x = self._norm(h, p["norm"], pl["norm"])
        w = self.whole(p["conv_w"], pl["conv_w"], partial=heads)
        b = self.whole(p["conv_b"], pl["conv_b"], partial=heads)
        if self.seq:          # the mixer runs on the gathered sequence
            x = self.gather_seq(x, partial=heads)
        elif heads:
            x = self.copy(x)
        if heads:
            n = cfg.d_inner // self.M
            w = conv_columns(w, cfg.d_inner, self.rank, n)
            b = conv_columns(b, cfg.d_inner, self.rank, n)
        out, conv_in, hT = mamba_local(cfg, self._mamba_leaves(p, heads), x,
                                       w, b, self._sumsq if heads else None)
        if self.seq:
            out = h + (self.scatter_seq(out) if heads else
                       self.split_seq(out))
        else:
            out = h + (self.reduce(out) if heads else out)
        if not return_state:
            return out
        tail = conv_in[:, conv_in.shape[1] - (cfg.ssm_conv - 1):]
        if heads:
            dl = tail.shape[-1] - 2 * cfg.ssm_state
            tail = torch.cat([self.gather(tail[..., :dl], -1),
                              tail[..., dl:]], dim=-1)
        return out, (tail, hT)

    def decode_mamba(self, p, h, conv_state, ssd_state, split: dict):
        """One token through the Mamba2 block on the rank's heads →
        (h′, the rank's block of the conv state′ (``split["conv"]``), the
        SSD state′ of its heads).  The conv runs on every column of the
        gathered state, so the rank writes back exactly its block."""
        cfg, pl = self.cfg, self.plan["mamba"]
        heads = self.mamba_heads()
        x = self._norm(h, p["norm"], pl["norm"])
        lp = self._mamba_leaves(p, heads)
        z, xi, Bp, Cp, dt = mamba_project(lp, x)
        if heads:
            xi = self.gather(xi, -1)
        conv_in = torch.cat([xi, Bp, Cp], dim=-1)[:, 0]
        if split["conv"] is not None:
            conv_state = self.gather(conv_state, split["conv"])
        y_conv, conv_state = L.conv1d_decode(
            conv_state, conv_in, self.whole(p["conv_w"], pl["conv_w"]),
            self.whole(p["conv_b"], pl["conv_b"]))
        if heads:
            y_conv = conv_columns(y_conv, cfg.d_inner, self.rank,
                                  cfg.d_inner // self.M)
        del xi, Bp, Cp
        dt = mamba_step_dt(lp, dt)
        out, ssd_state = mamba_step_local(cfg, lp, y_conv, dt, z, ssd_state,
                                          x.dtype,
                                          self._sumsq if heads else None)
        out = h + (self.reduce(out) if heads else out)
        return out, self.block(conv_state, split["conv"]), ssd_state

    def cross_kv(self, p, memory, split):
        """The rank's block of a decoder layer's cross k/v cache (``split``:
        2 the rank's kv heads, 1 its block of the memory's rows, None
        whole): ``memory @ wk`` / ``memory @ wv``, un-normed, no bias."""
        pl = self.plan["attn"]

        def one(n):
            if split == 2 and pl[n] == ATTN_MEGATRON[n]:
                return L.einsum("bsd,dhk->bshk", memory, p[n])
            t = L.einsum("bsd,dhk->bshk", memory, self.whole(p[n], pl[n]))
            return self.block(t, split)
        return one("wk"), one("wv")

    def decode_cross(self, p, h, ck, cv, split):
        """One-token cross-attention of the rank's heads to its block of
        the cached memory k/v (``split`` as in :meth:`cross_kv`)."""
        pl = self.plan["attn"]
        heads = self.heads_split()
        x = self._norm(h, p["norm"], pl["norm"])
        lp = {n: p[n] if heads else self.whole(p[n], pl[n])
              for n in ("wq", "wo")}
        if split == 1:
            ck, cv = self.gather(ck, 1), self.gather(cv, 1)
        out = cross_decode_local(self.cfg, lp, x, ck, cv, self.rank)
        return h + (self.reduce(out) if heads else out)

    # ---- cache ------------------------------------------------------------
    def cache_split(self, batch: int, ctx_len: int) -> dict:
        return cache_split(self.cfg, self.M, batch, ctx_len, self.rules)

    def block(self, t, dim: Optional[int]):
        """The rank's block of ``t`` along ``dim`` (``t`` whole)."""
        if dim is None:
            return t
        n = t.shape[dim] // self.M
        return t.narrow(dim, self.rank * n, n)

    def _local_slot(self, slot, n: int):
        """Each row's ring ``slot`` (a (B,) tensor) in the rank's block of
        ``n`` slots → (its index there, clamped into the block; whether the
        rank holds it)."""
        local = slot - self.rank * n
        return local.clamp(0, n - 1), (local >= 0) & (local < n)

    def decode_positions(self, cpos, pos, slot, split: dict, rows=None):
        """Writes ``pos`` into the positions buffer's ``slot`` where the
        rank holds it (``cpos``: the rank's block; ``split``: the cache's,
        :meth:`cache_split`) → every slot's positions.  Ragged (``rows``
        is ``arange(B)``): ``pos`` and ``slot`` are (B,) tensors and
        ``cpos`` the rank's block of the (B, W) buffer, split on its ctx
        dim (1); each row writes its slot through a mask where the rank
        holds it, with no host read."""
        if rows is not None:
            if split["positions"] is None:
                cpos[rows, slot] = pos.to(cpos.dtype)
                return cpos
            local, mine = self._local_slot(slot, cpos.shape[1])
            cpos[rows, local] = torch.where(mine, pos.to(cpos.dtype),
                                            cpos[rows, local])
            return self.gather(cpos, 1)
        n = cpos.shape[0]
        lo = self.rank * n if split["positions"] is not None else 0
        if lo <= slot < lo + n:
            cpos[slot - lo] = pos
        return cpos if split["positions"] is None else self.gather(cpos, 0)

    def decode_attn(self, p, h, kc, vc, cpos, cpos_all, pos, slot,
                    split: dict, window, rows=None):
        """One-token attention on the rank's cache blocks ``kc`` / ``vc``
        (ring split per ``split["ring"]``) and positions (``cpos`` the
        rank's block, ``cpos_all`` every slot's), writing the token's k/v
        where the rank holds its slot.  Lock-step: ``pos`` and ``slot`` are
        ints.  Ragged (``rows`` is ``arange(B)``): they are (B,) tensors,
        each row writes its own slot (through a mask on a ring split on
        ``ctx``) and attends at its own position."""
        cfg, heads = self.cfg, self.heads_split()
        x = self._norm(h, p["norm"], self.plan["attn"]["norm"])
        lp = self._attn_leaves(p, heads)
        if split["ring"] == 2:                   # the rank's kv heads
            out = decode_local(cfg, lp, x, kc, vc, cpos_all, pos, slot,
                               window, rows)
            return h + (self.reduce(out) if heads else out)
        q, k, v = decode_qkv(cfg, lp, x, pos, ragged=rows is not None)
        hq = q.shape[2]
        if heads:
            q = self.gather(q, 2)
        n = kc.shape[1]
        if rows is None:
            lo = self.rank * n if split["ring"] == 1 else 0
            if lo <= slot < lo + n:
                kc[:, slot - lo] = k[:, 0]
                vc[:, slot - lo] = v[:, 0]
        elif split["ring"] == 1:
            local, mine = self._local_slot(slot, n)
            mine = mine[:, None, None]
            kc[rows, local] = torch.where(mine, k[:, 0].to(kc.dtype),
                                          kc[rows, local])
            vc[rows, local] = torch.where(mine, v[:, 0].to(vc.dtype),
                                          vc[rows, local])
        else:
            kc[rows, slot] = k[:, 0]
            vc[rows, slot] = v[:, 0]
        if split["ring"] == 1:
            o = L.decode_attention_ctx(q, kc, vc, cpos, pos, window,
                                       self.amax, self.reduce)
        else:
            o = L.decode_attention(q, kc, vc, cpos_all, pos, window=window)
        if heads:
            o = o[:, :, self.rank * hq:(self.rank + 1) * hq]
        out = L.einsum("bshk,hkd->bsd", o, lp["wo"])
        return h + (self.reduce(out) if heads else out)


# ---------------------------------------------------------------------------
# model ranks as threads of one process
# ---------------------------------------------------------------------------

class ThreadRanks:
    """``M`` model ranks as threads of one process on one device, for
    checking the decomposition where the ranks cannot each have a device
    of their own (two ranks cannot share a card: NCCL refuses them).
    :meth:`run` calls ``fn(tp)`` in one thread per rank, with that rank's
    :class:`TP` over a ``collectives.LocalGroup``, whose collectives
    combine the ranks' tensors as the real ones would: a sum (in rank
    order) where they all-reduce, a max, a concatenation where they
    gather.  Every layer and operator is the product path's own.

    :meth:`run` runs under ``torch.no_grad`` by default; with ``grad`` it
    runs with autograd on, so the operators' backward passes run their
    collectives over the threads too, each thread's backward on that
    thread (``torch.autograd.set_multithreading_enabled(False)``: on a
    card the engine would otherwise run every rank's backward on the
    device's one worker thread, where the first collective would wait for
    ranks that never come)."""

    def __init__(self, cfg, M: int, rules=None, timeout: float = 600.0):
        from ..distributed.sharding import DEFAULT_RULES

        self.cfg, self.M = cfg, M
        self.rules = rules or DEFAULT_RULES
        self._barrier = threading.Barrier(M, timeout=timeout)
        self._board = [None] * M
        self._out = None

    def combine(self, rank: int, t, how):
        """``how`` of every rank's ``t`` (a list in rank order), once all
        the ranks have handed theirs in; rank 0 gets the result, the
        others a copy."""
        self._board[rank] = t
        if self._barrier.wait() == 0:
            self._out = how(self._board)
        self._barrier.wait()
        return self._out if rank == 0 else self._out.clone()

    def run(self, fn, grad: bool = False) -> list:
        """``fn(tp)`` on every rank → the ranks' results, in rank order; an
        error on any rank stops them all and is raised.  ``grad``: with
        autograd on (see the class)."""
        from ..distributed.collectives import LocalGroup

        outs, errs = [None] * self.M, []
        self._barrier.reset()

        def body(r):
            try:
                tp = TP(self.cfg, LocalGroup(self.combine, self.M, r),
                        self.M, r, self.rules)
                if grad:
                    with torch.enable_grad(), \
                            torch.autograd.set_multithreading_enabled(False):
                        outs[r] = fn(tp)
                else:
                    with torch.no_grad():
                        outs[r] = fn(tp)
            except BaseException as e:          # noqa: BLE001 (re-raised)
                errs.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.M)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise next((e for e in errs if not isinstance(
                e, threading.BrokenBarrierError)), errs[0])
        return outs
