"""Tensor parallelism over the mesh's model axis, for the dense and MoE
families.

The JAX package shards over the model axis by layout alone: every leaf
carries the ``PartitionSpec`` of ``logical_pspec`` and GSPMD inserts the
collectives.  The port computes the same function with explicit tensor
parallelism over the model group.  Each rank holds exactly the block of
every param and cache leaf that ``distributed.sharding.logical_pspec``
gives it (:func:`plan` reads those splits), and the layers compute
Megatron-style where the rules' split is a Megatron split:

* attention on each rank's heads when the rules split ``wq`` / ``wo`` on
  ``heads``: q column-split, k and v on the rank's kv heads (split on
  ``kv_heads``, or projected whole and the rank's kv heads taken), ``wo``
  row-split, the output summed over the ranks;
* the MLP column-split on ``ff`` (``w_gate``, ``w_up``) and row-split
  (``w_down``);
* the experts expert-parallel on ``experts``: the routing replicated, each
  rank running its E/M experts, the combine summed over the ranks
  (``layers.moe_ffn``);
* a vocab-parallel embedding and unembedding on ``vocab``, with the
  vocab-parallel cross entropy (``layers.vocab_parallel_xent``).

Where the rules pick another dim (a norm weight on ``embed``, the router
on ``experts``, qwen2-0.5b's attention at a model axis its 14 heads do not
divide), the leaf is gathered on use over the model group and the compute
through it is replicated.  ``distributed.collectives`` holds the operators
and the rule for a gathered leaf's gradient.

The rank-local parts (:func:`attn_local`, :func:`decode_local`,
:func:`embed_local`, :func:`kv_for_heads`, and the layers' ``moe_ffn`` /
``swiglu`` / ``vocab_parallel_xent`` on blocks) run no collective:
:class:`TP` runs them between its collectives, and the unsharded model
runs the same attention parts as rank 0 of one.  :class:`ThreadRanks`
runs the ranks as threads of one process whose operators combine the
ranks' tensors themselves, so the decomposition can be checked on one
device through the product path's own layers.

Decode: a ring cache the rules split on ``kv_heads`` decodes on each
rank's heads; one split on ``ctx`` (qwen2-0.5b at model 4: two kv heads)
runs every head over the rank's block of the slots, with the
distributed softmax of ``layers.decode_attention_ctx``; the logits of
prefill and decode are gathered whole over the vocabulary, so a greedy
pick is the first maximal index of the whole row on every rank.
"""
from __future__ import annotations

import functools
import threading
from typing import Optional

import torch

from ..kernels import ops
from . import layers as L
from .specs import torch_dtype

#: the dim of each attention leaf (per layer) that a Megatron split takes
ATTN_MEGATRON = {"wq": 1, "bq": 0, "wo": 0, "wk": 1, "wv": 1, "bk": 0,
                 "bv": 0}


def _split_dim(spec, mesh, rules) -> Optional[int]:
    from ..distributed.sharding import logical_pspec

    ps = logical_pspec(spec.axes, spec.shape, mesh, rules)
    return next((i for i, e in enumerate(ps) if e == rules.model_axis),
                None)


@functools.lru_cache(maxsize=64)
def plan(cfg, M: int, rules=None) -> dict:
    """The model-axis split dim of every param leaf of ``cfg`` at a model
    axis of ``M`` (None: whole on every rank), per layer: a stacked
    leaf's ``layers`` dim is dropped.  ``{"embed", "final_norm",
    "lm_head", "attn": {...}, "mlp" | "moe": {...}}``."""
    from ..distributed.sharding import DEFAULT_RULES
    from ..launch.mesh import Mesh
    from .model import param_specs

    rules = rules or DEFAULT_RULES
    mesh = Mesh({rules.model_axis: M})

    def walk(tree, stacked):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, stacked)
            else:
                d = _split_dim(v, mesh, rules)
                out[k] = d - 1 if stacked and d is not None else d
        return out

    specs = param_specs(cfg)
    out = walk({k: v for k, v in specs.items() if k != "blocks"}, False)
    out.update(walk(specs["blocks"], True))
    return out


def cache_split(cfg, M: int, batch: int, ctx_len: int, rules=None) -> dict:
    """The model-axis split dim of the lock-step cache's leaves, per
    layer for the ring: ``{"ring": 2 (kv_heads) | 1 (ctx) | None,
    "positions": 0 | None}``."""
    from ..distributed.sharding import DEFAULT_RULES
    from ..launch.mesh import Mesh
    from .model import cache_specs

    rules = rules or DEFAULT_RULES
    mesh = Mesh({rules.model_axis: M})
    specs = cache_specs(cfg, batch, ctx_len)
    ring = _split_dim(specs["self"]["k"], mesh, rules)
    return {"ring": None if ring is None else ring - 1,
            "positions": _split_dim(specs["positions"], mesh, rules)}


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
               causal: bool = True, src=None):
    """A rank's attention over the sequence → (out, k, v): ``out`` is its
    part of the block's output (B, S, d), to be summed over the ranks when
    ``wq`` / ``wo`` are split on heads (else the whole output), and ``k``
    / ``v`` as projected (the rank's kv heads, or all of them), for the
    cache.  ``src``: a cross-attention memory, the source of k and v (no
    RoPE, never causal); otherwise self-attention, with RoPE at
    ``positions`` when they are given.  Flash runs on the rank's heads
    when ``use_flash_attention``.  With no model axis this is the whole
    attention (rank 0 of one)."""
    q, k, v = project_qkv(cfg, p, x, src)
    if src is None and positions is not None:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    causal = causal and src is None
    hq = q.shape[2]
    ks = kv_for_heads(k, cfg.n_heads, cfg.n_kv_heads, hq, rank)
    vs = kv_for_heads(v, cfg.n_heads, cfg.n_kv_heads, hq, rank)
    if cfg.use_flash_attention:
        o = ops.flash_attention(q, ks, vs, causal=causal, window=window)
    else:
        o = L.attention(q, ks, vs, causal=causal, window=window)
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


# ---------------------------------------------------------------------------
# the product path: the rank-local parts between the collectives
# ---------------------------------------------------------------------------
class TP:
    """A model group (the active context's, ``distributed.sharding.
    model_context``) and ``cfg``'s :func:`plan` on it.  The model's entry
    points take one (``tp=``) or resolve the active context's once a call
    (:meth:`active`), and hand it down to every layer."""

    def __init__(self, cfg, group, M: int, rank: int, rules):
        self.cfg, self.group, self.M, self.rank = cfg, group, M, rank
        self.rules = rules
        self.plan = plan(cfg, M, rules)

    @classmethod
    def active(cls, cfg) -> Optional["TP"]:
        """The TP of the active context, or None (no context, or a model
        axis of 1); a family that does not run tensor-parallel raises
        ``NotImplementedError`` naming ROADMAP.md item 14b."""
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

    # ---- layers -----------------------------------------------------------
    def _norm(self, h, w, dim):
        return L.rms_norm(h, self.whole(w, dim), self.cfg.norm_eps)

    def _attn_leaves(self, p, heads: bool) -> dict:
        pl = self.plan["attn"]
        return {n: t if heads and pl[n] is not None
                and pl[n] == ATTN_MEGATRON.get(n)
                else self.whole(t, pl[n], partial=heads)
                for n, t in p.items() if n != "norm"}

    def heads_split(self) -> bool:
        return self.plan["attn"]["wq"] == ATTN_MEGATRON["wq"]

    def attn(self, p, h, *, positions=None, window=None, return_kv=False):
        x = self._norm(h, p["norm"], self.plan["attn"]["norm"])
        heads = self.heads_split()
        out, k, v = attn_local(self.cfg, self._attn_leaves(p, heads),
                               self.copy(x) if heads else x, self.rank,
                               positions=positions, window=window)
        out = h + (self.reduce(out) if heads else out)
        return (out, (k, v)) if return_kv else out

    def _swiglu(self, p, pl, x):
        """(rank part, whole part) of a SwiGLU: the first when it is
        split on ``ff``."""
        names = ("w_gate", "w_up", "w_down")
        if pl["w_gate"] == p["w_gate"].dim() - 1:
            return L.swiglu(self.copy(x), *(p[n] for n in names)), None
        return None, L.swiglu(x, *(self.whole(p[n], pl[n]) for n in names))

    @staticmethod
    def _sum(*ts):
        ts = [t for t in ts if t is not None]
        return ts[0] if len(ts) == 1 else sum(ts[1:], ts[0])

    def mlp(self, p, h):
        pl = self.plan["mlp"]
        x = self._norm(h, p["norm"], pl["norm"])
        part, whole = self._swiglu(p, pl, x)
        y = self._sum(None if part is None else self.reduce(part), whole)
        return h + y

    def moe(self, p, h):
        cfg, pl = self.cfg, self.plan["moe"]
        x = self._norm(h, p["norm"], pl["norm"])
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
        y = self._sum(self.reduce(self._sum(*parts)) if parts else None,
                      *wholes)
        return h + y, aux

    def embed(self, table, tokens):
        d, dt = self.plan["embed"], torch_dtype(self.cfg.dtype)
        if d == 0:
            return self.reduce(embed_local(table, tokens, self.rank).to(dt))
        return self.whole(table, d)[tokens].to(dt)

    def logits(self, params, h):
        """→ (logits, vocab-parallel): the rank's block of the vocabulary
        when the unembedding is split on ``vocab``, else the whole."""
        if self.cfg.tie_embeddings:
            t, d, eq, vdim = params["embed"], self.plan["embed"], \
                "bsd,vd->bsv", 0
        else:
            t, d, eq, vdim = params["lm_head"], self.plan["lm_head"], \
                "bsd,dv->bsv", 1
        if d == vdim:
            return L.einsum(eq, self.copy(h), t), True
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

    # ---- cache ------------------------------------------------------------
    def cache_split(self, batch: int, ctx_len: int) -> dict:
        return cache_split(self.cfg, self.M, batch, ctx_len, self.rules)

    def block(self, t, dim: Optional[int]):
        """The rank's block of ``t`` along ``dim`` (``t`` whole)."""
        if dim is None:
            return t
        n = t.shape[dim] // self.M
        return t.narrow(dim, self.rank * n, n)

    def decode_positions(self, cpos, pos: int, slot: int, batch: int,
                         ctx_len: int):
        """Writes ``pos`` into the positions buffer's ``slot`` where the
        rank holds it (``cpos``: the rank's block) → (the cache's split,
        every slot's positions)."""
        split = self.cache_split(batch, ctx_len)
        n = cpos.shape[0]
        lo = self.rank * n if split["positions"] is not None else 0
        if lo <= slot < lo + n:
            cpos[slot - lo] = pos
        cpos_all = cpos if split["positions"] is None else \
            self.gather(cpos, 0)
        return split, cpos_all

    def decode_attn(self, p, h, kc, vc, cpos, cpos_all, pos: int, slot: int,
                    split: dict, window):
        """One-token attention on the rank's cache blocks ``kc`` / ``vc``
        (ring split per ``split["ring"]``) and positions (``cpos`` the
        rank's block, ``cpos_all`` every slot's), writing the token's k/v
        where the rank holds its slot."""
        cfg, heads = self.cfg, self.heads_split()
        x = self._norm(h, p["norm"], self.plan["attn"]["norm"])
        lp = self._attn_leaves(p, heads)
        if split["ring"] == 2:                   # the rank's kv heads
            out = decode_local(cfg, lp, x, kc, vc, cpos_all, pos, slot,
                               window)
            return h + (self.reduce(out) if heads else out)
        q, k, v = decode_qkv(cfg, lp, x, pos)
        hq = q.shape[2]
        if heads:
            q = self.gather(q, 2)
        n = kc.shape[1]
        lo = self.rank * n if split["ring"] == 1 else 0
        if lo <= slot < lo + n:
            kc[:, slot - lo] = k[:, 0]
            vc[:, slot - lo] = v[:, 0]
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
    :meth:`run` calls ``fn(tp)`` in one thread per rank, under
    ``torch.no_grad``, with that rank's :class:`TP`, whose operators
    combine the ranks' tensors as the collectives would: a sum (in rank
    order) where they all-reduce, a max, a concatenation where they
    gather.  Every layer between them is the product path's own."""

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

    def run(self, fn) -> list:
        """``fn(tp)`` on every rank → the ranks' results, in rank order; an
        error on any rank stops them all and is raised."""
        outs, errs = [None] * self.M, []
        self._barrier.reset()

        def body(r):
            try:
                with torch.no_grad():
                    outs[r] = fn(_ThreadRank(self, r))
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


class _ThreadRank(TP):
    """Rank ``rank`` of a :class:`ThreadRanks`: the operators combine over
    the threads (forward only)."""

    def __init__(self, ranks: ThreadRanks, rank: int):
        super().__init__(ranks.cfg, None, ranks.M, rank, ranks.rules)
        self._ranks = ranks

    def copy(self, t):
        return t

    def reduce(self, t):
        return self._ranks.combine(self.rank, t,
                                   lambda ts: functools.reduce(torch.add, ts))

    def amax(self, t):
        return self._ranks.combine(
            self.rank, t, lambda ts: functools.reduce(torch.maximum, ts))

    def gather(self, t, dim: int):
        d = dim % t.dim()
        return self._ranks.combine(self.rank, t, lambda ts: torch.cat(ts, d))

    def whole(self, t, dim: Optional[int], partial: bool = False):
        return t if dim is None else self.gather(t, dim)
