"""Pooled optimizer state: the whole server update as one kernel per dtype.

Counterpart of ``repro/optim/pool.py``.  The per-leaf fused route launches
one update kernel per parameter leaf (14 for qwen2-0.5b); this module
flattens the params, moments and delayed buffer into per-dtype contiguous
pool buffers once, at trainer init, so the whole update (clip, the Adam or
SGD(+momentum) step, bias corrections, weight decay, delay scale, the
gbuf ← fresh-grads swap and the guard rails' run flag) is one launch of
the same kernels per dtype pool: O(n_dtypes) launches instead of
O(n_leaves).

Layout (the JAX package's, array-equal to it).  A pool is an
``(n_shards, cols)`` buffer: leaf ``l``, padded to ``n_shards · width_l``
elements and chunked row-major, owns the column band
``[col_l, col_l + width_l)`` of every row, so row ``r`` holds shard ``r``
of every leaf.  Without a mesh the trainer builds its layout with
``n_shards=1``, where a leaf's band is one contiguous run of the pool and
:func:`unpool_tree` returns views into it (the model computes on the
pool's own storage, and a round copies no params).  On a data-parallel
mesh of R ranks (the counterpart of JAX's ``shard_map`` over the data
axes) the layout has R shards, rank r owns row r of every pool (ZeRO: it
keeps only that row of m, v and gbuf), the update kernels run on the row,
and the global norm is the ranks' per-pool norms gathered
(:func:`pooled_global_norm` with ``mesh``); with more than one shard
:func:`unpool_tree` copies.

Padding invariant: :func:`pool_tree` zero-fills pad columns and every
kernel keeps zeros there (moments start at 0, weight decay multiplies a 0
parameter), so :func:`pooled_global_norm` is exact as one reduction per
pool.

The updates work in place, as the port's per-leaf fused route does: the
kernels of :mod:`repro_torch.kernels.ops` run on each pool's flat storage
(the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor), and
``count`` ticks in place by the run flag.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..kernels import ops
from ..kernels.async_update import momentum_scalars, sgd_scalars
from ..tree import tree_leaves, tree_leaves_with_path
from .optimizers import (OptConfig, _adam_scal, _run, _tick,
                         clip_scale_from_norm, global_norm)

F32 = torch.float32


def _dtype_key(dt) -> str:
    """``"bfloat16"`` / ``"float32"`` for a torch dtype or a dtype name."""
    return str(dt).removeprefix("torch.")


def _torch_dtype(key: str) -> torch.dtype:
    return getattr(torch, key)


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's view into its dtype pool."""

    index: int          # position in the tree's flatten order
    path: str           # keystr (debugging / error messages)
    shape: tuple
    dtype: str          # dtype key of the pool group (the param dtype)
    col: int            # first column in the (n_shards, cols) pool
    width: int          # columns owned = ceil(size / n_shards)
    size: int


@dataclasses.dataclass(frozen=True)
class PoolLayout:
    """tree ↔ per-dtype ``(n_shards, cols)`` pool buffers, built once.

    ``groups`` maps a dtype key to the slots of every leaf of that dtype,
    in tree-flatten order; ``cols`` is each group's column count.  The same
    layout serves params, grads and the f32 moments (moments pool under the
    param's group).  ``treedef`` is the tree's skeleton: its dicts with
    each leaf replaced by its flatten index."""

    n_shards: int
    groups: dict        # dtype key → tuple[LeafSlot, ...]
    cols: dict          # dtype key → total columns
    treedef: Any
    n_leaves: int

    @property
    def n_pools(self) -> int:
        return len(self.groups)


def _skeleton(tree, counter):
    if not isinstance(tree, dict):
        counter[0] += 1
        return counter[0] - 1
    return {k: _skeleton(tree[k], counter) for k in sorted(tree)}


def _unflatten(skel, leaves):
    if not isinstance(skel, dict):
        return leaves[skel]
    return {k: _unflatten(v, leaves) for k, v in skel.items()}


def build_layout(tree, n_shards: int = 1) -> PoolLayout:
    """The pooled layout of ``tree`` (tensors, or anything with ``.shape``
    and ``.dtype``, such as :class:`repro_torch.models.specs.Spec`),
    chunked for ``n_shards`` shards."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    groups: dict = {}
    cols: dict = {}
    leaves_p = tree_leaves_with_path(tree)
    for index, (path, leaf) in enumerate(leaves_p):
        dk = _dtype_key(leaf.dtype)
        shape = tuple(leaf.shape)
        size = 1
        for n in shape:
            size *= int(n)
        width = -(-size // n_shards)          # ceil
        slot = LeafSlot(index=index, path=path, shape=shape, dtype=dk,
                        col=cols.get(dk, 0), width=width, size=size)
        groups.setdefault(dk, []).append(slot)
        cols[dk] = slot.col + width
    return PoolLayout(n_shards=n_shards,
                      groups={k: tuple(v) for k, v in groups.items()},
                      cols=cols, treedef=_skeleton(tree, [0]),
                      n_leaves=len(leaves_p))


def pool_tree(layout: PoolLayout, tree, dtype=None) -> dict:
    """tree → {dtype key: (n_shards, cols) pool}, new tensors on the
    leaves' device.  ``dtype`` overrides the pool element type (f32
    moments pooling under their param's group).  Pad columns are zero."""
    leaves = tree_leaves(tree)
    if len(leaves) != layout.n_leaves:
        raise ValueError(
            f"tree has {len(leaves)} leaves, layout expects {layout.n_leaves}")
    n = layout.n_shards
    pools = {}
    for dk, slots in layout.groups.items():
        blocks = []
        for s in slots:
            flat = leaves[s.index].reshape(-1)
            if dtype is not None:
                flat = flat.to(dtype)
            pad = n * s.width - s.size
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            blocks.append(flat.view(n, s.width))
        pools[dk] = torch.cat(blocks, dim=1) if len(blocks) > 1 \
            else blocks[0].clone()
    return pools


def unpool_tree(layout: PoolLayout, pools: dict):
    """{dtype key: pool} → tree.  With one shard each leaf is a view into
    its pool (no copy: an in-place update of the pool is seen by the
    leaf); with more it is a copy."""
    leaves: list = [None] * layout.n_leaves
    for dk, slots in layout.groups.items():
        pool = pools[dk]
        for s in slots:
            if layout.n_shards == 1:
                flat = pool[0, s.col:s.col + s.size]
            else:
                flat = pool[:, s.col:s.col + s.width].reshape(-1)[:s.size]
            leaves[s.index] = flat.view(s.shape)
    return _unflatten(layout.treedef, leaves)


def pool_zeros(layout: PoolLayout, dtype=None, device="cuda",
               rows=None) -> dict:
    """Zero pools (moments / delayed buffer init) on ``device``: ``rows``
    rows (a rank's one, on a mesh), ``n_shards`` by default."""
    n = layout.n_shards if rows is None else rows
    return {dk: torch.zeros(
        (n, layout.cols[dk]),
        dtype=_torch_dtype(_dtype_key(dtype) if dtype is not None else dk),
        device=device) for dk in layout.groups}


def init_pools(layout: PoolLayout, params, delayed: bool = True,
               rows=None) -> dict:
    """Fresh pooled optimizer state from a params tree, on its device: per
    dtype group ``{"p", "m", "v"}`` (+ a zero ``"gbuf"`` when
    ``delayed``, in the params' dtype: the grads it buffers have it), the
    JAX package's schema.  ``rows`` gives m, v and gbuf that many rows (1:
    a rank's ZeRO row); ``p`` is always whole."""
    device = tree_leaves(params)[0].device
    p_pools = pool_tree(layout, params)
    m_pools = pool_zeros(layout, "float32", device, rows)
    v_pools = pool_zeros(layout, "float32", device, rows)
    pools = {}
    for dk in layout.groups:
        p = p_pools[dk]
        grp = {"p": p, "m": m_pools[dk], "v": v_pools[dk]}
        if delayed:
            grp["gbuf"] = p.new_zeros(m_pools[dk].shape)
        pools[dk] = grp
    return pools


def pooled_global_norm(pools: dict, mesh=None, axes=()) -> torch.Tensor:
    """Global L2 norm over pool buffers, accumulated in f32: one reduction
    per pool (exact, because pad columns hold zeros).  With a bound
    ``mesh`` the pools are this rank's rows: every rank's per-pool norms
    are all-gathered over ``axes`` and the norm taken over them all, the
    same value on every rank (at one rank, bit for bit the mesh-free
    norm)."""
    if mesh is None:
        return global_norm(pools)
    from ..distributed.collectives import all_gather

    norms = torch.stack([torch.linalg.vector_norm(p, dtype=F32)
                         for p in tree_leaves(pools)])
    return torch.linalg.vector_norm(all_gather(norms, mesh.group(axes)))


# ---------------------------------------------------------------------------
# the fused pooled apply
# ---------------------------------------------------------------------------
def _apply_groups(grad_pools, pools, count, cfg: OptConfig, lr_scale, *,
                  delayed: bool, run, mesh, axes):
    """Shared body of :func:`pooled_update` / :func:`pooled_delayed_apply`:
    one kernel launch per dtype pool, in place."""
    if cfg.name not in ("adam", "sgd"):
        raise ValueError(cfg.name)
    source = ({dk: pools[dk]["gbuf"] for dk in pools} if delayed
              else grad_pools)
    gnorm = pooled_global_norm(source, mesh, axes)
    clip = clip_scale_from_norm(gnorm, cfg.clip_norm)
    opt = {"count": count}
    count = _tick(opt, run)
    device = count.device
    if cfg.name == "adam":
        scal = _adam_scal(cfg, clip, count, lr_scale, run)
        kw = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps)
    elif cfg.momentum:
        scal = momentum_scalars(cfg.lr, clip, lr_scale, device, _run(run))
    else:
        scal = sgd_scalars(cfg.lr, clip, lr_scale, device, _run(run))
    for dk, b in pools.items():
        g = grad_pools[dk]
        if cfg.name == "adam":
            if delayed:
                ops.fused_adam_delayed(b["p"], b["m"], b["v"], b["gbuf"], g,
                                       scal, **kw)
            else:
                ops.fused_adam(b["p"], b["m"], b["v"], g, scal, **kw)
        elif cfg.momentum:
            if delayed:
                ops.sgd_momentum_delayed(b["p"], b["m"], b["gbuf"], g, scal,
                                         momentum=cfg.momentum)
            else:
                ops.sgd_momentum_step(b["p"], b["m"], g, scal,
                                      momentum=cfg.momentum)
        elif delayed:
            ops.async_update(b["p"], b["gbuf"], g, scal)
        else:
            ops.sgd_step(b["p"], g, scal)
    return pools, count, gnorm


def pooled_update(grad_pools, pools, count, cfg: OptConfig, lr_scale=1.0, *,
                  run=None, mesh=None, axes=()):
    """Synchronous pooled server update (``delay_rounds == 0``): pools ←
    step(pools; clip·grad_pools), one kernel per dtype pool, in place.

    ``pools`` is ``{dtype: {"p", "m", "v"}}`` and ``count`` the int32
    step count, ticked in place by ``run`` (the guard rails' device flag;
    ``None`` is the unguarded 1).  Returns ``(pools, count, gnorm)`` with
    ``gnorm`` the pre-clip norm of the applied gradient.  With a bound
    ``mesh`` and its data ``axes`` the pools are this rank's rows, as
    under JAX's ``shard_map`` (:func:`pooled_global_norm`)."""
    return _apply_groups(grad_pools, pools, count, cfg, lr_scale,
                         delayed=False, run=run, mesh=mesh, axes=axes)


def pooled_delayed_apply(grad_pools, pools, count, cfg: OptConfig,
                         lr_scale=1.0, *, run=None, mesh=None, axes=()):
    """The delayed server update (eq. 2) over pooled state, one kernel per
    dtype pool, in place:

        p, m, v ← step(p, m, v; clip·gbuf)   (apply the stale gradient)
        gbuf    ← grad_pools                 (buffer the fresh one)

    ``pools`` is ``{dtype: {"p", "m", "v", "gbuf"}}``.  At ``run`` 0 every
    kernel writes nothing and ``count`` stays.  Returns
    ``(pools, count, gnorm)``; ``gnorm`` is the pre-clip norm of the
    applied (stale) gradient.  ``mesh`` and ``axes`` as in
    :func:`pooled_update`."""
    return _apply_groups(grad_pools, pools, count, cfg, lr_scale,
                         delayed=True, run=run, mesh=mesh, axes=axes)
