"""Optimizers of the AsGrad server update, with the fused kernels as a route.

Counterpart of ``repro/optim/optimizers.py``:

* SGD and Adam (f32 moments whatever the param dtype) with the paper's
  Assumption-4 clipping by global norm, as functional updates of trees;
* the delayed-buffer apply, the AsGrad server update (eq. 2) as one call.

``update_impl`` selects how a step executes.  ``"reference"`` is the tree
of elementwise torch ops and returns new tensors.  ``"pallas"`` and
``"pallas_interpret"`` are both accepted, so one spec reads alike in both
packages, and both route every leaf through the fused update kernels of
:mod:`repro_torch.kernels.ops`: on a CUDA tensor the CUDA kernel, on a CPU
tensor its plain version.  The route follows the device only; there is no
off-device degradation and no switch that runs the plain version on the
card.  The fused route updates params, moments, count and buffer IN PLACE
(the JAX step donates them) and returns the same tensors.

SGD with ``momentum > 0`` on a fused impl runs the heavy-ball kernels
(``sgd_momentum_step``, and ``sgd_momentum_delayed`` for the delayed
apply), the f32 momentum buffer riding the same pass.

The fused updates take ``run``, the guard rails' skip gate: a device
scalar (1 or 0, from the round's finite check) that rides the kernels'
scalar block and ticks ``count`` in place, so a skipped round launches
every kernel, writes nothing and leaves ``count`` where it was, with no
host read.  ``None`` is the unguarded 1.  The reference updates are
functional and take no gate: the trainer selects their result per leaf.

The pooled impls (``"pallas_pooled"``, ``"pallas_pooled_interpret"``;
the second, like ``"pallas_interpret"``, routes by the device) change the
state layout to per-dtype pool buffers, so they live outside the tree
contract of :func:`make_optimizer` and :func:`make_delayed_apply`, which
refuse them with the JAX package's words: :mod:`repro_torch.optim.pool`
runs them, and ``AsyncTrainer`` routes there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels import ops
from ..kernels.async_update import (adam_bias_corrections, adam_scalars,
                                    momentum_scalars, sgd_scalars)
from ..tree import tree_leaves, tree_map

F32 = torch.float32

UPDATE_IMPLS = ("reference", "pallas", "pallas_interpret",
                "pallas_pooled", "pallas_pooled_interpret")


def resolve_update_impl(impl: str) -> str:
    """Validate ``impl``; the port runs what is asked for or raises."""
    if impl not in UPDATE_IMPLS:
        raise ValueError(
            f"unknown update_impl {impl!r}; want one of {UPDATE_IMPLS}")
    return impl


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adam"            # adam | sgd
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.0         # sgd only
    clip_norm: Optional[float] = 1.0   # Assumption 4 enforcement
    #: reference | pallas | pallas_interpret | pallas_pooled |
    #: pallas_pooled_interpret
    update_impl: str = "reference"


def global_norm(tree, split=None, groups=None) -> torch.Tensor:
    """√Σ‖leaf‖², accumulated in f32 on the leaves' device.

    With ``split`` (a matching tree of ``distributed.sharding.split_axes``
    classes: ``""``, ``"data"``, ``"model"`` or ``"data+model"``) the tree
    holds a rank's blocks: each leaf's squares are summed over exactly the
    groups it is split over (``groups``: ``{"data": ..., "model": ...}``),
    and a leaf whole on every rank is counted once.  Two small
    all-reduces do it: the model-split classes' sums over the model group,
    then the data-split ones' over the data group."""
    leaves = tree_leaves(tree)
    norms = torch.stack([torch.linalg.vector_norm(l, dtype=F32)
                         for l in leaves])
    if split is None:
        return torch.linalg.vector_norm(norms)
    from ..distributed.collectives import all_reduce

    classes = tree_leaves(split)
    sq = norms * norms

    def part(cls):
        mask = torch.tensor([c == cls for c in classes], device=sq.device)
        return torch.sum(torch.where(mask, sq, 0.0))

    data = any(c.startswith("data") for c in classes)
    model = any(c.endswith("model") for c in classes)
    whole = part("")
    if data and model:
        red = all_reduce(torch.stack([part("model"), part("data+model")]),
                         groups["model"])
        both = all_reduce(torch.stack([part("data"), red[1]]),
                          groups["data"])
        return torch.sqrt(both[0] + both[1] + red[0] + whole)
    if data or model:
        name = "data" if data else "model"
        return torch.sqrt(all_reduce(part(name), groups[name]) + whole)
    return torch.sqrt(whole)


def clip_by_global_norm(tree, max_norm: float, norm_fn=global_norm):
    norm = norm_fn(tree)
    scale = clip_scale_from_norm(norm, max_norm)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), tree), norm


def clip_scale_from_norm(norm, max_norm: Optional[float]) -> torch.Tensor:
    """The global-norm clip factor from an already-computed norm, with the
    JAX package's epsilon (reference and fused routes must agree on it)."""
    if not max_norm:
        return torch.ones((), dtype=F32, device=norm.device)
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0).to(F32)


def clip_scale_by_global_norm(tree, max_norm: Optional[float],
                              norm_fn=global_norm):
    """(scale, norm) without materialising the scaled tree: the fused route
    folds ``scale`` into the kernels' scalars."""
    norm = norm_fn(tree)
    return clip_scale_from_norm(norm, max_norm), norm


def adam_init(params):
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _unzip(out, n: int):
    """tree-of-n-tuples → n-tuple-of-trees."""
    return tuple(tree_map(lambda t, i=i: t[i], out) for i in range(n))


def adam_update(grads, opt_state, params, cfg: OptConfig, lr_scale=1.0,
                norm_fn=global_norm):
    """``norm_fn``, here and in every update below, takes the global norm
    of the gradient tree (a rank's blocks: :func:`global_norm` with
    ``split``)."""
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm_fn)
    else:
        gnorm = norm_fn(grads)
    count = opt_state["count"] + 1
    b1, b2 = cfg.beta1, cfg.beta2
    c = count.to(F32)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)

    def upd(p, g, m, v):
        g32 = g.to(F32)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.to(F32)
        # cast the STEP, not the params, as the JAX reference does
        newp = p - (cfg.lr * lr_scale * step).to(p.dtype)
        return newp, m, v

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    newp, m, v = _unzip(out, 3)
    return newp, {"m": m, "v": v, "count": count}, gnorm


def sgd_update(grads, opt_state, params, cfg: OptConfig, lr_scale=1.0,
               norm_fn=global_norm):
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm_fn)
    else:
        gnorm = norm_fn(grads)
    if cfg.momentum:
        m = tree_map(lambda mo, g: cfg.momentum * mo + g.to(F32),
                     opt_state["m"], grads)
        step_tree = m
    else:
        m = opt_state["m"]
        step_tree = grads
    newp = tree_map(
        lambda p, s: p - (cfg.lr * lr_scale * s.to(F32)).to(p.dtype),
        params, step_tree)
    count = opt_state["count"] + 1
    return newp, {"m": m, "v": opt_state["v"], "count": count}, gnorm


# --------------------------------------------------------------------------
# fused execution of the same updates (in place)
# --------------------------------------------------------------------------
def _tick(opt_state, run=None):
    """count += run in place on the device (no host read): by 1 on every
    round that applies, the gated round 0 included, as JAX increments it
    before use; by 0 on a round the guards skip."""
    count = opt_state["count"]
    count.add_(1 if run is None else run.to(count.dtype))
    return count


def _run(run):
    """The run flag for a scalar block: the unguarded 1 when ``None``."""
    return 1.0 if run is None else run


def _adam_scal(cfg, clip_scale, count, lr_scale, run=None):
    bc1, bc2 = adam_bias_corrections(cfg.beta1, cfg.beta2, count)
    return adam_scalars(cfg.lr * lr_scale, bc1, bc2, clip_scale,
                        cfg.weight_decay, count.device,
                        run=_run(run))


def _leaf_map(fn, *trees):
    """``fn`` over matching leaves, for its side effects (in-place kernels)."""
    for leaves in zip(*(tree_leaves(t) for t in trees)):
        fn(*leaves)


def fused_adam_update(grads, opt_state, params, cfg: OptConfig, lr_scale=1.0,
                      run=None, norm_fn=global_norm):
    """``adam_update`` semantics, one ``fused_adam`` launch per leaf: the
    clip factor, bias corrections, weight decay and ``run`` ride the scalar
    block."""
    clip_scale, gnorm = clip_scale_by_global_norm(grads, cfg.clip_norm,
                                                  norm_fn)
    scal = _adam_scal(cfg, clip_scale, _tick(opt_state, run), lr_scale, run)
    kw = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps)
    _leaf_map(lambda p, g, m, v: ops.fused_adam(p, m, v, g, scal, **kw),
              params, grads, opt_state["m"], opt_state["v"])
    return params, opt_state, gnorm


def fused_sgd_update(grads, opt_state, params, cfg: OptConfig, lr_scale=1.0,
                     run=None, norm_fn=global_norm):
    """SGD through the swap-free ``sgd_step`` kernel, one launch per leaf;
    with ``cfg.momentum`` the f32 momentum buffer rides the same pass
    (``sgd_momentum_step``)."""
    clip_scale, gnorm = clip_scale_by_global_norm(grads, cfg.clip_norm,
                                                  norm_fn)
    count = _tick(opt_state, run)
    run = _run(run)
    if cfg.momentum:
        scal = momentum_scalars(cfg.lr, clip_scale, lr_scale, count.device,
                                run)
        _leaf_map(lambda p, m, g: ops.sgd_momentum_step(
            p, m, g, scal, momentum=cfg.momentum),
            params, opt_state["m"], grads)
    else:
        scal = sgd_scalars(cfg.lr, clip_scale, lr_scale, count.device, run)
        _leaf_map(lambda p, g: ops.sgd_step(p, g, scal), params, grads)
    return params, opt_state, gnorm


# --------------------------------------------------------------------------
# delayed-buffer apply: the AsGrad server update (eq. 2) as ONE operation
# --------------------------------------------------------------------------
def reference_delayed_apply(grads, gbuf, opt_state, params, cfg: OptConfig,
                            lr_scale=1.0, norm_fn=global_norm):
    """Apply the STALE buffer, store the fresh grads.

    Returns (new_params, new_gbuf, new_opt_state, gnorm) where ``gnorm`` is
    the pre-clip norm of the APPLIED (stale) gradient."""
    update = adam_update if cfg.name == "adam" else sgd_update
    newp, new_opt, gnorm = update(gbuf, opt_state, params, cfg,
                                  lr_scale=lr_scale, norm_fn=norm_fn)
    return newp, grads, new_opt, gnorm


def fused_delayed_apply(grads, gbuf, opt_state, params, cfg: OptConfig,
                        lr_scale=1.0, run=None, norm_fn=global_norm):
    """Per leaf, ONE kernel consumes the stale buffer, steps the params
    (and the moments for Adam, the momentum for heavy-ball SGD) and writes
    the fresh gradient into the buffer, all in place; at ``run`` 0 every
    kernel writes nothing."""
    clip_scale, gnorm = clip_scale_by_global_norm(gbuf, cfg.clip_norm,
                                                  norm_fn)
    count = _tick(opt_state, run)
    if cfg.name == "adam":
        scal = _adam_scal(cfg, clip_scale, count, lr_scale, run)
        kw = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps)
        _leaf_map(lambda p, gb, g, m, v: ops.fused_adam_delayed(
            p, m, v, gb, g, scal, **kw),
            params, gbuf, grads, opt_state["m"], opt_state["v"])
    elif cfg.momentum:
        scal = momentum_scalars(cfg.lr, clip_scale, lr_scale, count.device,
                                _run(run))
        _leaf_map(lambda p, m, gb, g: ops.sgd_momentum_delayed(
            p, m, gb, g, scal, momentum=cfg.momentum),
            params, opt_state["m"], gbuf, grads)
    else:
        scal = sgd_scalars(cfg.lr, clip_scale, lr_scale, count.device,
                           _run(run))
        _leaf_map(lambda p, gb, g: ops.async_update(p, gb, g, scal),
                  params, gbuf, grads)
    return params, gbuf, opt_state, gnorm


def _resolve(cfg: OptConfig) -> str:
    impl = resolve_update_impl(cfg.update_impl)
    if cfg.name not in ("adam", "sgd"):
        raise ValueError(cfg.name)
    return impl


def make_optimizer(cfg: OptConfig):
    """(init_fn, update_fn) for ``cfg``, routed through ``cfg.update_impl``:
    ``update(grads, opt_state, params, cfg, lr_scale) → (p', state', gnorm)``.
    The pooled impls change the state layout and raise (use
    :mod:`repro_torch.optim.pool`)."""
    impl = _resolve(cfg)
    if impl.startswith("pallas_pooled"):
        raise ValueError(
            f"update_impl={cfg.update_impl!r} pools the state into per-dtype "
            "buffers and cannot serve the tree-based optimizer contract; "
            "use repro_torch.optim.pool (AsyncTrainer does this "
            "automatically)")
    if impl == "reference":
        return adam_init, adam_update if cfg.name == "adam" else sgd_update
    return adam_init, (fused_adam_update if cfg.name == "adam"
                       else fused_sgd_update)


def make_delayed_apply(cfg: OptConfig):
    """The delayed-buffer server update as one callable:

        apply(grads, gbuf, opt_state, params, cfg, lr_scale)
            → (new_params, new_gbuf, new_opt_state, gnorm)

    The pooled impls operate on pooled state and raise."""
    impl = _resolve(cfg)
    if impl.startswith("pallas_pooled"):
        raise ValueError(
            f"update_impl={cfg.update_impl!r} operates on pooled state; use "
            "repro_torch.optim.pool.pooled_delayed_apply (AsyncTrainer does "
            "this automatically)")
    if impl == "reference":
        return reference_delayed_apply
    return fused_delayed_apply
