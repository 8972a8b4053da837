"""AsGrad's buffered-asynchronous training round, on one device or over the
data ranks of a process mesh.

Counterpart of ``repro/distributed/async_trainer.py``.  The ``n`` AsGrad
workers are the data groups of the global batch (group g owns examples
``[g·B/n, (g+1)·B/n)``); a round's 0/1 participation mask over the groups
becomes per-example loss weights; staleness is the round delay: the
gradient applied at round q was computed at round q−1's params and waited
in ONE delayed buffer ``gbuf``.  ``delay_rounds = 0`` is synchronous SGD
(the paper's baseline).

Without a mesh, ``n_groups`` is 1 until the backend sets it to the spec's
worker count, and nothing is sharded.  The round is eager PyTorch:
forward and backward through ``models.loss_fn`` (autograd), then the
server update through ``optim`` — with ``update_impl="pallas"`` one fused
CUDA kernel per param leaf that updates the state in place.  No value is
read back to the host inside a round: the step-0 gate, the clip scale and
the bias corrections stay device tensors.

Scenario and fault channels, as the JAX step applies them:

* ``fault_gain`` — the participation-weighted mean gain over the round's
  participants scales the loss, its parts and the grads (a corrupted or
  poisoned receipt);
* ``grad_density`` — each gradient leaf keeps the entries whose magnitude
  reaches the (1 − density) quantile of |g|, the quantile taken as
  ``jnp.quantile`` takes it (:func:`quantile_index`, :func:`sparsify`);
* ``guards`` (:class:`repro_torch.faults.GuardConfig`) — a round whose
  loss or raw (fresh, sparsified) gradient norm is not finite is skipped:
  params, moments, count and the delay buffer keep their bits, the step
  counter advances, ``skipped`` reads 1 and ``grad_norm`` 0; a per-worker
  health vector backs the stepsize off after bad receipts.  The skip
  stays on the device: on the fused route the finite flag rides the
  update kernels' scalar block as their run flag (a skipped round still
  launches every kernel, which then writes nothing); on the reference
  route, which builds new tensors, each leaf is selected with
  ``torch.where``.

The pooled impls (``update_impl="pallas_pooled"``, and its
``"_interpret"`` twin, which routes by the device as well) keep the state
in per-dtype pool buffers (:mod:`repro_torch.optim.pool`, one shard): the
model's params are views into the ``p`` pool, so a round copies no
params; the fresh grads are pooled once (a copy, as JAX's ``pool_tree``
is), after the fault gain, the sparsifier and the finite check; and the
whole server update is one kernel launch per dtype pool.

``cfg.remat == "full"`` (every ``ArchConfig``'s default) recomputes each
layer's activations in the backward pass (:func:`repro_torch.models.
model.forward_logits`), as JAX's ``jax.checkpoint`` over the layer scan.

**Over ranks** (``mesh``: a ``launch.mesh.ProcessMesh`` whose data axes,
pod × data, hold R ranks and whose model axis is 1), as the JAX trainer
maps the paper onto a mesh: the AsGrad workers' examples are weighted
from the global mask over the global batch (every rank draws the same
batch), and rank r keeps its rows: ``[r·B/R, (r+1)·B/R)``, or with k
microbatches its share of each, ``[i·B/k + r·B/(kR), i·B/k +
(r+1)·B/(kR))`` (JAX splits the batch into microbatches first and shards
each over the data axes).  Each rank computes its share of the
participation-weighted loss and gradient (``models.loss_fn`` under the
step's activation context: the CE over the global Σ mask, the MoE's
groups), and the reported loss, CE and aux are the shares all-reduced,
equal on every rank.  Then, on the pooled route, the rank pools its
gradient share in JAX's ``(R, cols)`` layout, reduce-scatters it over the
data group (in the grads' dtype) into its ZeRO row, runs the update
kernel once per dtype pool on its row of p, m, v and gbuf (it keeps only
that row of m, v and gbuf; ``p`` stays whole, since the forward reads
every param), and all-gathers the ``p`` rows.  The per-leaf routes hold
per-leaf ZeRO, the JAX trainer's ``state_shardings(fsdp_params=True)``:
each rank keeps its block of every leaf of params, m, v and gbuf, split
over the data axes on the first free ``zero_names`` dim they divide
(``tree_shardings(..., zero=True)``; a leaf nothing divides stays whole
over the data ranks).  The model gathers each layer's blocks over the
data group when it reads them (``models.tp.ZeroGather``, inside the block
that remat recomputes, so under ``remat="full"`` a gathered layer is
freed after use and gathered again in the backward; under ``"none"``
autograd keeps every gathered layer), and the gather's backward
reduce-scatters each gradient into the rank's block: no whole gradient
leaf is formed, and the update kernels run on the blocks.  A leaf left
whole is all-reduced.  With a sparsifier (``grad_density``) each leaf's
quantile is over the whole gradient, so the pooled route all-reduces the
leaves first and takes its row of them, and the per-leaf routes gather
each block, sparsify and take the block again.  The guards' raw norm and
finite flag are global (the norm from the ranks' per-pool norms, or the
blocks' squares summed over the groups each leaf is split over), so
every rank takes the same skip decision with no host read.  Every
collective is functional and counted
(:mod:`repro_torch.distributed.collectives`).

**Over the model axis** (a mesh whose ``model`` axis holds M > 1 ranks;
every family) the forward and backward are tensor-parallel
(:mod:`repro_torch.models.tp`): the model ranks of a data group hold the
same batch rows and compute on their blocks of the params.  A leaf that
several layers read (the hybrid's shared attention and MLP, used by every
group) sums its gradient over its uses, each already through its
operator's rule, before the update.  On the per-leaf routes every leaf of
the state (params, m, v, gbuf) is the rank's block under the rules
(``state_shardings``): its model block, split again over the data axes
by per-leaf ZeRO (above); the gather over the data group hands the
model-axis code the model block.  The global clip norm sums each leaf's
squares over exactly the groups it is split over and counts the whole
ones once.  On the pooled route the pools stay replicated over the
model axis, as JAX's ``pooled_pspec`` says: the forward reads the rank's
blocks as views of the whole params, and the fresh grads of the split
leaves are all-gathered over the model group before they are pooled.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..faults.guards import GuardConfig
from ..models import model as M
from ..models.specs import Spec
from ..models.tp import ZeroGather
from ..optim import (OptConfig, adam_init, global_norm, make_delayed_apply,
                     make_optimizer, resolve_update_impl)
from ..optim.pool import (build_layout, init_pools, pool_tree,
                          pooled_delayed_apply, pooled_global_norm,
                          pooled_update, unpool_tree)
from ..tree import tree_leaves, tree_map
from . import collectives as C
from .sharding import (DEFAULT_RULES, NamedSharding, PSpec, Rules,
                       check_model_axis, local_specs, pool_axes, pooled_pspec,
                       sharded_trace, split_axes, tree_shardings)

F32 = torch.float32


def quantile_index(n: int, density) -> tuple:
    """Where ``jnp.quantile(a, 1 − density)`` (method ``linear``) reads an
    ``n``-element ``a``, in its own f32 arithmetic: ``(low, high, low
    weight, high weight)``.  JAX converts n to f32 and forms q·(n − 1) in
    f32, which above 2^24 elements is not exact; this repeats it step by
    step in numpy f32, on the host (the density is a plan value the host
    holds), so the device is never read."""
    one, zero = np.float32(1.0), np.float32(0.0)
    dens = np.clip(np.float32(density), zero, one)
    q = one - dens
    nf = np.float32(n)
    q = q * (nf - one)
    low, high = np.floor(q), np.ceil(q)
    hw = q - low
    lw = one - hw
    low = np.minimum(np.maximum(low, zero), nf - one)
    high = np.minimum(np.maximum(high, zero), nf - one)
    return int(low), int(high), lw, hw


def sparsify(g: torch.Tensor, density) -> torch.Tensor:
    """Magnitude top-k of one gradient leaf at keep-``density``: zero every
    entry below the (1 − density) quantile of |g| (f32), as the JAX step
    does (``jnp.quantile`` refuses nothing; ``torch.quantile`` refuses more
    than 2^24 elements, so the two order statistics come from a sort and
    the interpolation from :func:`quantile_index`).  A NaN anywhere makes
    the threshold NaN, as in JAX, so nothing finite is kept.  Density 1 is
    the identity bit for bit (the threshold is min |g|).

    The product ``g * keep`` is the JAX step's, as written: a dropped
    negative entry is −0 and a NaN stays NaN.  XLA's CPU compile rewrites
    the f32 product into a select (dropped entries +0, a dropped NaN 0)
    and keeps the bf16 one, so on bf16 grads (every config's dtype) the
    two agree bit for bit, and on f32 up to the sign of a dropped zero and
    a NaN in a leaf the guards skip."""
    low, high, lw, hw = quantile_index(g.numel(), density)
    a = g.to(F32).abs().reshape(-1)
    srt = torch.sort(a).values
    thr = srt[low] * lw + srt[high] * hw
    thr = torch.where(torch.isnan(a).any(), torch.nan, thr)
    del srt
    keep = (a >= thr).reshape(g.shape)
    return g * keep.to(g.dtype)


def held_state_bytes(state) -> int:
    """Bytes of the params, moments and delayed buffer in a trainer state
    as the rank holds it (its ZeRO blocks; a pooled state: its pools)."""
    held = [state["pools"]] if "pools" in state else \
        [state["params"], state["opt"]["m"], state["opt"]["v"],
         state.get("gbuf", {})]
    return sum(t.numel() * t.element_size()
               for tree in held for t in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    delay_rounds: int = 1          # 0 = synchronous baseline
    delay_adaptive: bool = False   # scale lr by 1/(delay+1) ([32]-style)
    aux_coeff: float = 0.01        # MoE load-balance coefficient
    microbatches: int = 1          # gradient accumulation (memory lever)
    #: None → take ``OptConfig.update_impl``; set to override per-trainer
    update_impl: Optional[str] = None
    #: device-side guard rails: non-finite rounds skip the apply with no
    #: host read, and a per-worker health vector backs the effective
    #: stepsize off after bad receipts.  None builds the exact unguarded
    #: step (no extra state, no checks)
    guards: Optional[GuardConfig] = None


class AsyncTrainer:
    """(arch config × optimizer × delay) → a train step on ``device``;
    with ``mesh`` (a bound ``launch.mesh.ProcessMesh``) the step of this
    rank of its data and model axes."""

    def __init__(self, cfg: ArchConfig, opt: OptConfig = OptConfig(),
                 async_cfg: AsyncConfig = AsyncConfig(), device="cuda", *,
                 mesh=None, rules: Rules = DEFAULT_RULES):
        if async_cfg.guards is not None and \
                not isinstance(async_cfg.guards, GuardConfig):
            raise TypeError("AsyncConfig.guards must be a GuardConfig, got "
                            f"{type(async_cfg.guards).__name__}")
        self.cfg = cfg
        if async_cfg.update_impl is not None:
            opt = dataclasses.replace(opt, update_impl=async_cfg.update_impl)
        self.opt = opt
        self.async_cfg = async_cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = rules
        self.ranks, self.rank, self.model = 1, 0, 1
        #: per-leaf ZeRO's gather on use (None: no leaf split over data)
        self.zero = None
        self._norm = global_norm
        if mesh is not None:
            if not getattr(mesh, "bound", False):
                raise TypeError("AsyncTrainer's mesh must be bound to the "
                                "process group (launch.mesh.bind)")
            check_model_axis(cfg, mesh, rules)
            self.data_axes = pool_axes(mesh, rules)
            self.ranks = mesh.count(self.data_axes)
            self.rank = mesh.my_index(self.data_axes)
            self.model = mesh.count((rules.model_axis,))
        #: the worker groups: the data-axis product (1 without a mesh),
        #: until the backend sets the spec's worker count
        self.n_groups = self.ranks
        self.update_impl = resolve_update_impl(opt.update_impl)
        #: pooled impls flatten the whole state into per-dtype pools once
        #: here, one row per rank; the update is then one kernel per dtype
        #: pool (on this rank's row), not one per leaf
        self.pooled = self.update_impl.startswith("pallas_pooled")
        if self.pooled:
            self.pool_layout = build_layout(M.param_specs(cfg), self.ranks)
            if self.model > 1:
                #: each param leaf's layout over the model axis (the forward
                #: reads these blocks of the whole pooled params)
                self.param_shardings = tree_shardings(M.param_specs(cfg),
                                                      mesh, rules)
        else:
            _, self._update = make_optimizer(opt)
            self._delayed_apply = make_delayed_apply(opt)
        if mesh is not None and not self.pooled:
            #: each param leaf's layout (and m's, v's and gbuf's): the
            #: model split and per-leaf ZeRO over the data axes, JAX's
            #: ``state_shardings(fsdp_params=True)``
            self.leaf_shardings = tree_shardings(M.param_specs(cfg), mesh,
                                                 rules, zero=True)
            self.zero = ZeroGather.of(cfg, mesh, rules)
            classes = tree_map(lambda sh: split_axes(sh.spec, mesh, rules),
                               self.leaf_shardings)
            #: the leaves whose gradient the backward already sums over
            #: the data ranks (the gathered ones' reduce-scatter)
            self._summed = tree_map(lambda c: c.startswith("data"), classes)
            names = {n for c in tree_leaves(classes) for n in c.split("+")
                     if n}
            if names:
                axes = {"data": self.data_axes, "model": (rules.model_axis,)}
                self._norm = functools.partial(
                    global_norm, split=classes,
                    groups={n: mesh.group(axes[n]) for n in names})

    @property
    def ranked(self) -> bool:
        return self.mesh is not None

    # ------------------------------------------------------------------ state
    def _pooled_state_specs(self):
        """Pooled state as Specs: per dtype group one ``(n_shards, cols)``
        pool each for p (param dtype), m and v (f32) and, when delayed,
        gbuf (param dtype); over ranks m, v and gbuf are this rank's row,
        ``(1, cols)``."""
        lay = self.pool_layout
        pool = lambda dk, dtype, n=lay.n_shards: Spec(
            (n, lay.cols[dk]), (None, None), "zeros", dtype)
        rows = 1 if self.ranked else lay.n_shards      # a rank's ZeRO row
        pools = {}
        for dk in lay.groups:
            grp = {"p": pool(dk, dk), "m": pool(dk, "float32", rows),
                   "v": pool(dk, "float32", rows)}
            if self.async_cfg.delay_rounds > 0:
                grp["gbuf"] = pool(dk, dk, rows)
            pools[dk] = grp
        return {"pools": pools,
                "opt": {"count": Spec((), (), "zeros", "int32")},
                "step": Spec((), (), "zeros", "int32")}

    def _tree_state_specs(self):
        pspecs = M.param_specs(self.cfg)
        f32_like = lambda s: Spec(s.shape, s.axes, "zeros", "float32")
        specs = {
            "params": pspecs,
            "opt": {"m": tree_map(f32_like, pspecs),
                    "v": tree_map(f32_like, pspecs),
                    "count": Spec((), (), "zeros", "int32")},
            "step": Spec((), (), "zeros", "int32"),
        }
        if self.async_cfg.delay_rounds > 0:
            specs["gbuf"] = tree_map(
                lambda s: Spec(s.shape, s.axes, "zeros", s.dtype), pspecs)
        return specs

    def state_specs(self):
        """State tree as Specs: params, f32 moments, counters, and the
        delayed buffer (param dtype) when ``delay_rounds > 0``; on a pooled
        impl the pools, the count and the step instead."""
        specs = self._pooled_state_specs() if self.pooled \
            else self._tree_state_specs()
        if self.async_cfg.guards is not None:
            specs["guard"] = {"health": Spec((self.n_groups,), (None,),
                                             "zeros", "float32")}
        return specs

    def local_state_specs(self):
        """The state this rank holds, as Specs: :meth:`state_specs` with
        each per-leaf route's split leaf its block, over the model axis and
        per-leaf ZeRO over the data axes (the pooled route's specs are
        already the rank's: p whole, its row of m, v and gbuf)."""
        specs = self.state_specs()
        if not self.ranked or self.pooled:
            return specs
        return local_specs(specs, self.state_shardings())

    def init_state(self, seed: int = 0, params=None):
        """A fresh state; ``params`` (a whole tree on the trainer's device)
        replaces the port's own init from ``seed``.  Over a mesh the
        per-leaf routes keep each leaf's block (:meth:`state_shardings`),
        each its own contiguous tensor, as the update kernels want."""
        blocks = self.ranked and not self.pooled
        if params is None:
            params = M.init_params(
                self.cfg, seed, self.device,
                shardings=self.leaf_shardings if blocks else None)
        elif blocks:
            params = tree_map(lambda t, sh: sh.local(t).clone(
                memory_format=torch.contiguous_format), params,
                self.leaf_shardings)
        zero = lambda: torch.zeros((), dtype=torch.int32, device=self.device)
        delayed = self.async_cfg.delay_rounds > 0
        if self.pooled:
            rows = 1 if self.ranked else None
            state = {"pools": init_pools(self.pool_layout, params, delayed,
                                         rows),
                     "opt": {"count": zero()}, "step": zero()}
        else:
            state = {"params": params, "opt": adam_init(params),
                     "step": zero()}
            if delayed:
                state["gbuf"] = tree_map(torch.zeros_like, params)
        if self.async_cfg.guards is not None:
            # every worker starts at full health (scale 1 = unguarded γ)
            state["guard"] = {"health": torch.ones(
                (self.n_groups,), dtype=F32, device=self.device)}
        return state

    def params_of(self, state):
        """The params tree of a trainer state, whatever its layout: the
        tree itself, or on a pooled state views into the ``p`` pools (an
        in-place update of the pools shows through them; over R > 1
        ranks a copy, since each leaf is striped over the rows)."""
        if self.pooled:
            return unpool_tree(self.pool_layout,
                               {dk: b["p"] for dk, b in
                                state["pools"].items()})
        return state["params"]

    def state_shardings(self):
        """One :class:`~repro_torch.distributed.sharding.NamedSharding` per
        state leaf (the JAX trainer's ``state_shardings`` with its default
        ``fsdp_params=True``): on the pooled route m, v and gbuf are split
        by rows over the data axes (``pooled_pspec``) and ``p`` is whole on
        every rank; on the per-leaf routes params, m, v and gbuf are split
        over the model axis by the rules and over the data axes by
        per-leaf ZeRO (``tree_shardings(..., zero=True)``: the first free
        ``zero_names`` dim the data axes divide; a leaf with none stays
        whole over the data ranks); count, step and the guards' health
        are replicated."""
        if not self.ranked:
            raise ValueError("state_shardings needs a mesh")
        out = tree_map(lambda spec: NamedSharding(
            self.mesh, PSpec(*([None] * len(spec.shape)))),
            self.state_specs())
        if not self.pooled:
            out["params"] = out["opt"]["m"] = out["opt"]["v"] = \
                self.leaf_shardings
            if "gbuf" in out:
                out["gbuf"] = self.leaf_shardings
        rows = NamedSharding(self.mesh, pooled_pspec(self.mesh, self.rules))
        for b in out.get("pools", {}).values():
            for k in ("m", "v", "gbuf"):
                if k in b:
                    b[k] = rows
        return out

    # ------------------------------------------------------------- train step
    def _example_weights(self, mask, batch_size: int):
        """mask (n_groups,) → per-example weights (B,): group g owns the
        contiguous slice [g·B/n, (g+1)·B/n)."""
        if batch_size % self.n_groups:
            raise ValueError(f"the {self.n_groups} groups must divide the "
                             f"batch of {batch_size}")
        return mask.repeat_interleave(batch_size // self.n_groups)

    def _rank_rows(self, bsz: int, k: int, device) -> torch.Tensor:
        """The global batch rows this rank holds, in order: its block of
        each of the k microbatches (JAX shards each microbatch over the
        data axes)."""
        mb = bsz // k
        if mb % self.ranks:
            raise ValueError(f"the {self.ranks} data ranks must divide each "
                             f"microbatch of {mb} rows")
        per = mb // self.ranks
        lo = self.rank * per
        return torch.cat([torch.arange(i * mb + lo, i * mb + lo + per,
                                       device=device) for i in range(k)])

    def _value_and_grad(self, params, batch, w):
        """(loss, parts, grads in the params' dtypes) by autograd, on
        detached leaves that share the params' storage.  Under per-leaf
        ZeRO the leaves are the rank's blocks, gathered on use, and each
        gradient is its block's, summed over the data ranks."""
        with torch.enable_grad():
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            loss, parts = M.loss_fn(self.cfg, leaves, batch,
                                    example_weights=w,
                                    aux_coeff=self.async_cfg.aux_coeff,
                                    zero=self.zero)
            loss.backward()
        grads = tree_map(lambda p: p.grad, leaves)
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    def _grad_pools(self, grads, reduced: bool) -> dict:
        """The fresh grads pooled: whole without a mesh; over ranks this
        rank's row, reduce-scattered from the shares (or, once ``reduced``
        to the global grads, taken from them)."""
        pools = pool_tree(self.pool_layout, grads)
        if not self.ranked:
            return pools
        if reduced:
            return {dk: p.narrow(0, self.rank, 1) for dk, p in pools.items()}
        group = self.mesh.group(self.data_axes)
        return {dk: C.reduce_scatter(p, group) for dk, p in pools.items()}

    def train_step_fn(self):
        """``step(state, batch, mask, delay_scale=None, grad_density=None,
        fault_gain=None) → (state, metrics)``.

        ``delay_scale`` is the optional per-round stepsize scale
        (γ_q = γ·delay_scale_q, a device scalar) fed from the realised
        schedule's delay metadata; omitted, the static ``delay_adaptive``
        1/(1+delay_rounds) rule applies.  ``grad_density`` is the round's
        keep-density, a host number (the plan's; the quantile's index
        arithmetic runs on the host); ``fault_gain`` the round's
        ``(n_groups,)`` per-worker gains.  With ``delay_rounds > 0`` the
        whole server update (consume the stale ``gbuf``, step params and
        moments, buffer the fresh grads) is one delayed-apply call, and
        round 0, whose buffer is empty, is gated to a zero step on the
        device.  Every metric is a device scalar.  Over ranks ``batch`` and
        ``mask`` are the global ones, the same on every rank (module
        docstring)."""
        acfg = self.async_cfg
        fused = self.update_impl != "reference"
        ranked = self.ranked
        group = self.mesh.group(self.data_axes) if ranked else None
        mesh_kw = {"mesh": self.mesh, "axes": self.data_axes} if ranked \
            else {}

        # the pooled route over a model axis: the pools are whole there
        psh = self.param_shardings if self.model > 1 and self.pooled \
            else None

        def step(state, batch, mask, delay_scale=None, grad_density=None,
                 fault_gain=None):
            params = self.params_of(state)
            # what the forward reads: the rank's blocks (views of the
            # whole params on the pooled route)
            fwd = tree_map(lambda t, sh: sh.local(t), params, psh) \
                if psh is not None else params
            bsz = batch["tokens"].shape[0]
            mask = mask.to(F32)
            w = self._example_weights(mask, bsz)
            k = acfg.microbatches
            k = k if k > 1 and bsz % k == 0 else 1
            if ranked:
                rows = self._rank_rows(bsz, k, w.device)
                batch = {n: x.index_select(0, rows.to(x.device))
                         for n, x in batch.items()}
                w = w.index_select(0, rows)
            if fault_gain is not None:
                # the gain scales the round's received contribution after
                # the CE's weight normalisation (folded into the weights it
                # would cancel); a non-participant's gain, NaN included,
                # is masked out
                gain = torch.where(mask > 0, torch.as_tensor(
                    fault_gain, dtype=F32, device=self.device), 1.0)
                n_part = mask.sum()
                fault_c = torch.where(
                    n_part > 0,
                    (mask * gain).sum() / torch.clamp(n_part, min=1e-6),
                    1.0)

            if k > 1:
                # gradient accumulation over k microbatches, grads in f32
                mb = w.shape[0] // k
                g32 = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                     device=p.device), fwd)
                loss = aux = 0.0
                for i in range(k):
                    sl = slice(i * mb, (i + 1) * mb)
                    l, parts_i, g = self._value_and_grad(
                        fwd, {n: x[sl] for n, x in batch.items()}, w[sl])
                    g32 = tree_map(lambda a, x: a + x.to(F32) / k, g32, g)
                    loss = loss + l / k
                    aux = aux + parts_i["aux"] / k
                grads = tree_map(lambda g, p: g.to(p.dtype), g32, fwd)
                parts = {"ce": loss, "aux": aux}
            else:
                loss, parts, grads = self._value_and_grad(fwd, batch, w)
            if psh is not None:
                # the pool is whole over the model axis: so are its grads
                grads = tree_map(lambda g, sh: sh.gather(g), grads, psh)
            if ranked:
                # the shares summed: the loss of the whole batch, equal on
                # every rank
                red = C.all_reduce(torch.stack(
                    [loss, parts["ce"], torch.as_tensor(
                        parts["aux"], dtype=F32, device=self.device)]), group)
                loss, parts = red[0], {"ce": red[1], "aux": red[2]}
            if fault_gain is not None:
                # what the server receives is scaled, loss and grads alike,
                # so the guard sees exactly what the step would apply
                loss = loss * fault_c
                parts = {n: v * fault_c for n, v in parts.items()}
                grads = tree_map(lambda g: g * fault_c.to(g.dtype), grads)
            # over ranks the per-leaf routes, and a sparsifier (a quantile
            # over the whole leaf), need the global gradient leaves: each
            # share summed over the data ranks (per-leaf ZeRO's gathered
            # leaves come out of the backward summed, as their blocks)
            reduced = ranked and (not self.pooled or grad_density is not None)
            if reduced and self.pooled:
                grads = tree_map(lambda g: C.all_reduce(g, group), grads)
            elif reduced:
                grads = tree_map(lambda g, done: g if done else
                                 C.all_reduce(g, group), grads, self._summed)
            if grad_density is not None and ranked and not self.pooled:
                # the quantile over the whole leaf, then the rank's block
                grads = tree_map(
                    lambda g, sh: sh.local(sparsify(sh.gather(g),
                                                    grad_density)).contiguous(),
                    grads, self.leaf_shardings)
            elif grad_density is not None:
                grads = tree_map(lambda g: sparsify(g, grad_density), grads)
            if self.pooled:
                # the fresh grads pooled once, after the fault gain and the
                # sparsifier (a copy, as JAX's ``pool_tree`` is)
                gpools = self._grad_pools(grads, reduced)
                if ranked:
                    del grads

            if acfg.guards is not None:
                # the raw norm of the FRESH grads, before they can be
                # buffered: the delayed apply's own norm is the stale one's
                gd = acfg.guards
                raw_norm = pooled_global_norm(gpools, **mesh_kw) \
                    if self.pooled and ranked else self._norm(grads)
                finite = torch.isfinite(loss) & torch.isfinite(raw_norm)
                bad = ~finite
                if gd.spike_norm is not None:
                    bad = bad | (raw_norm > gd.spike_norm)
                h = state["guard"]["health"]
                gscale = (h * mask).sum() / torch.clamp(mask.sum(), min=1.0)
                h_next = torch.clamp(
                    torch.where(mask > 0,
                                torch.where(bad, h * gd.backoff,
                                            torch.clamp(h * gd.recover,
                                                        max=1.0)),
                                h),
                    gd.min_scale, 1.0)
                run = finite.to(F32)

            if delay_scale is not None:
                lr_scale = torch.as_tensor(delay_scale, dtype=F32,
                                           device=self.device)
            elif acfg.delay_adaptive and acfg.delay_rounds > 0:
                lr_scale = 1.0 / (1.0 + acfg.delay_rounds)
            else:
                lr_scale = 1.0
            # skip the very first round (empty buffer) via a device gate
            if acfg.delay_rounds > 0:
                gate = (state["step"] != 0).to(F32)
            else:
                gate = torch.ones((), dtype=F32, device=self.device)
            if acfg.guards is not None:
                # participation-weighted mean health scales this round's γ
                gate = gate * gscale
            kw = {"run": run} if acfg.guards is not None and fused else {}
            if not self.pooled:
                kw["norm_fn"] = self._norm

            if self.pooled:
                apply = pooled_delayed_apply if acfg.delay_rounds > 0 \
                    else pooled_update
                pools = state["pools"]
                if ranked:
                    # this rank's row of every pool: p's row is a view of
                    # the whole p, m / v / gbuf are the row itself
                    pools = {dk: {**b, "p": b["p"].narrow(0, self.rank, 1)}
                             for dk, b in pools.items()}
                pools, count, gnorm = apply(
                    gpools, pools, state["opt"]["count"], self.opt,
                    lr_scale=lr_scale * gate, **kw, **mesh_kw)
                if ranked:
                    pools = {dk: {**b, "p": C.all_gather(b["p"], group)}
                             for dk, b in pools.items()}
                new_state = {"pools": pools, "opt": {"count": count},
                             "step": state["step"] + 1}
            elif acfg.delay_rounds > 0:
                new_params, new_gbuf, new_opt, gnorm = self._delayed_apply(
                    grads, state["gbuf"], state["opt"], params, self.opt,
                    lr_scale=lr_scale * gate, **kw)
                new_state = {"params": new_params, "opt": new_opt,
                             "step": state["step"] + 1, "gbuf": new_gbuf}
            else:
                new_params, new_opt, gnorm = self._update(
                    grads, state["opt"], params, self.opt,
                    lr_scale=lr_scale * gate, **kw)
                new_state = {"params": new_params, "opt": new_opt,
                             "step": state["step"] + 1}
            zero = torch.zeros((), dtype=F32, device=self.device)
            if acfg.guards is None:
                skipped, gscale = zero, zero + 1.0
            else:
                if not fused:
                    # the reference route built new tensors: a skipped
                    # round keeps every old leaf, bit for bit
                    for key in [n for n in new_state if n != "step"]:
                        new_state[key] = tree_map(
                            lambda new, old: torch.where(finite, new, old),
                            new_state[key], state[key])
                new_state["guard"] = {"health": h_next}
                gnorm = torch.where(finite, gnorm, zero)
                skipped = 1.0 - run
            metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                       "grad_norm": gnorm, "participation": mask.mean(),
                       "skipped": skipped, "gscale": gscale}
            return new_state, metrics

        return sharded_trace(step, self.mesh, self.rules) if ranked else step
