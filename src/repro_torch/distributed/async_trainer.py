"""AsGrad's buffered-asynchronous training round, on one device.

Counterpart of ``repro/distributed/async_trainer.py``.  The ``n`` AsGrad
workers are the data groups of the global batch (group g owns examples
``[g·B/n, (g+1)·B/n)``); a round's 0/1 participation mask over the groups
becomes per-example loss weights; staleness is the round delay: the
gradient applied at round q was computed at round q−1's params and waited
in ONE delayed buffer ``gbuf``.  ``delay_rounds = 0`` is synchronous SGD
(the paper's baseline).

One device, no mesh: ``n_groups`` is 1 until the backend sets it to the
spec's worker count, and nothing is sharded.  The round is eager PyTorch:
forward and backward through ``models.loss_fn`` (autograd), then the
server update through ``optim`` — with ``update_impl="pallas"`` one fused
CUDA kernel per param leaf that updates the state in place.  No value is
read back to the host inside a round: the step-0 gate, the clip scale and
the bias corrections stay device tensors.

Not ported yet, and raising ``NotImplementedError``: the guard rails
(``guards``), the ``grad_density`` and ``fault_gain`` channels, and the
pooled state layout (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models import model as M
from ..models.specs import Spec
from ..optim import (OptConfig, adam_init, make_delayed_apply,
                     make_optimizer, resolve_update_impl)
from ..tree import tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    delay_rounds: int = 1          # 0 = synchronous baseline
    delay_adaptive: bool = False   # scale lr by 1/(delay+1) ([32]-style)
    aux_coeff: float = 0.01        # MoE load-balance coefficient
    microbatches: int = 1          # gradient accumulation (memory lever)
    #: None → take ``OptConfig.update_impl``; set to override per-trainer
    update_impl: Optional[str] = None
    #: the JAX package's device-side guard rails; not ported yet
    guards: Optional[object] = None


class AsyncTrainer:
    """(arch config × optimizer × delay) → a train step on ``device``."""

    def __init__(self, cfg: ArchConfig, opt: OptConfig = OptConfig(),
                 async_cfg: AsyncConfig = AsyncConfig(), device="cuda"):
        if async_cfg.guards is not None:
            raise NotImplementedError(
                "guard rails (AsyncConfig.guards / TrainJob.guards) are not "
                "ported yet; they come with the faults slice (ROADMAP.md "
                "queue 1)")
        if cfg.remat != "none":
            raise NotImplementedError(
                f"remat={cfg.remat!r} is not ported yet; train with "
                "remat='none'")
        self.cfg = cfg
        if async_cfg.update_impl is not None:
            opt = dataclasses.replace(opt, update_impl=async_cfg.update_impl)
        self.opt = opt
        self.async_cfg = async_cfg
        self.device = resolve_device(device)
        #: one device, no mesh: the backend sets the worker-group count
        self.n_groups = 1
        self.update_impl = resolve_update_impl(opt.update_impl)
        _, self._update = make_optimizer(opt)
        self._delayed_apply = make_delayed_apply(opt)

    # ------------------------------------------------------------------ state
    def state_specs(self):
        """State tree as Specs: params, f32 moments, counters, and the
        delayed buffer (param dtype) when ``delay_rounds > 0``."""
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

    def init_state(self, seed: int = 0, params=None):
        """A fresh state; ``params`` (a tree on the trainer's device)
        replaces the port's own init from ``seed``."""
        if params is None:
            params = M.init_params(self.cfg, seed, self.device)
        state = {
            "params": params,
            "opt": adam_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=self.device),
        }
        if self.async_cfg.delay_rounds > 0:
            state["gbuf"] = tree_map(torch.zeros_like, params)
        return state

    # ------------------------------------------------------------- train step
    def _example_weights(self, mask, batch_size: int):
        """mask (n_groups,) → per-example weights (B,): group g owns the
        contiguous slice [g·B/n, (g+1)·B/n)."""
        if batch_size % self.n_groups:
            raise ValueError(f"the {self.n_groups} groups must divide the "
                             f"batch of {batch_size}")
        return mask.repeat_interleave(batch_size // self.n_groups)

    def _value_and_grad(self, params, batch, w):
        """(loss, parts, grads in the params' dtypes) by autograd, on
        detached leaves that share the params' storage."""
        with torch.enable_grad():
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            loss, parts = M.loss_fn(self.cfg, leaves, batch,
                                    example_weights=w,
                                    aux_coeff=self.async_cfg.aux_coeff)
            loss.backward()
        grads = tree_map(lambda p: p.grad, leaves)
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    def train_step_fn(self):
        """``step(state, batch, mask, delay_scale=None) → (state, metrics)``.

        ``delay_scale`` is the optional per-round stepsize scale
        (γ_q = γ·delay_scale_q, a device scalar) fed from the realised
        schedule's delay metadata; omitted, the static ``delay_adaptive``
        1/(1+delay_rounds) rule applies.  With ``delay_rounds > 0`` the
        whole server update (consume the stale ``gbuf``, step params and
        moments, buffer the fresh grads) is one delayed-apply call, and
        round 0, whose buffer is empty, is gated to a zero step on the
        device.  Every metric is a device scalar."""
        acfg = self.async_cfg

        def step(state, batch, mask, delay_scale=None, grad_density=None,
                 fault_gain=None):
            if grad_density is not None or fault_gain is not None:
                raise NotImplementedError(
                    "the grad_density and fault_gain channels are not ported "
                    "yet (scenarios and faults, ROADMAP.md queue 1)")
            params = state["params"]
            bsz = batch["tokens"].shape[0]
            mask = mask.to(F32)
            w = self._example_weights(mask, bsz)

            k = acfg.microbatches
            if k > 1 and bsz % k == 0:
                # gradient accumulation over k microbatches, grads in f32
                mb = bsz // k
                g32 = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                     device=p.device), params)
                loss = aux = 0.0
                for i in range(k):
                    sl = slice(i * mb, (i + 1) * mb)
                    l, parts_i, g = self._value_and_grad(
                        params, {n: x[sl] for n, x in batch.items()}, w[sl])
                    g32 = tree_map(lambda a, x: a + x.to(F32) / k, g32, g)
                    loss = loss + l / k
                    aux = aux + parts_i["aux"] / k
                grads = tree_map(lambda g, p: g.to(p.dtype), g32, params)
                parts = {"ce": loss, "aux": aux}
            else:
                loss, parts, grads = self._value_and_grad(params, batch, w)

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

            if acfg.delay_rounds > 0:
                new_params, new_gbuf, new_opt, gnorm = self._delayed_apply(
                    grads, state["gbuf"], state["opt"], params, self.opt,
                    lr_scale=lr_scale * gate)
                new_state = {"params": new_params, "opt": new_opt,
                             "step": state["step"] + 1, "gbuf": new_gbuf}
            else:
                new_params, new_opt, gnorm = self._update(
                    grads, state["opt"], params, self.opt,
                    lr_scale=lr_scale * gate)
                new_state = {"params": new_params, "opt": new_opt,
                             "step": state["step"] + 1}
            zero = torch.zeros((), dtype=F32, device=self.device)
            metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                       "grad_norm": gnorm, "participation": mask.mean(),
                       "skipped": zero, "gscale": zero + 1.0}
            return new_state, metrics

        return step
