"""Execute an :class:`ExperimentSpec` (serving slice).

Counterpart of ``repro/api/backends.py``.  :class:`ServeBackend` runs the
lock-step lane: init params from the seed, draw the prompts with numpy
(the same ``default_rng(seed)`` stream as the JAX package), prefill, take
the first token by argmax, then decode ``T − 1`` steps through
:class:`repro_torch.distributed.Server`.  The simulator and trainer
backends arrive with the training slice.
"""
from __future__ import annotations

import time
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..device import resolve_device, synchronize
from ..kernels import flash_attention as flash_kernel
from .result import RunResult
from .spec import ExperimentSpec, ServeJob


@runtime_checkable
class Backend(Protocol):
    name: str

    def run(self, spec: ExperimentSpec) -> RunResult: ...


class ServeBackend:
    """Prefill + lock-step batched decode on ``device`` (default CUDA).

    ``RunResult.x`` is the (batch, T) int32 token matrix; ``extra`` holds
    ``prompts``, ``arch``, ``prefill_seconds``, ``decode_seconds``,
    ``tok_per_s``, ``logits_finite`` and ``flash_launches`` (the flash
    kernel's launch counter read before and after the run)."""

    name = "serve"

    def __init__(self, device="cuda"):
        self.device = device

    def run(self, spec: ExperimentSpec) -> RunResult:
        from ..distributed import Server, ServeConfig
        from ..models import init_params, prefill

        job = spec.objective
        if not isinstance(job, ServeJob):
            raise TypeError("ServeBackend needs a ServeJob objective")
        device = resolve_device(self.device)
        t0 = time.time()
        launches0 = flash_kernel.launches
        cfg = job.make_arch()
        params = init_params(cfg, spec.seed, device)
        ctx = job.prompt_len + spec.T
        server = Server(cfg, ServeConfig(batch=job.batch, ctx_len=ctx,
                                         temperature=job.temperature,
                                         seed=spec.seed), device=device)
        prompts = np.random.default_rng(spec.seed).integers(
            0, cfg.vocab, (job.batch, job.prompt_len)).astype(np.int32)
        tokens = torch.as_tensor(prompts, dtype=torch.int64, device=device)

        synchronize(device)
        t_pre = time.time()
        last, cache = prefill(cfg, params, {"tokens": tokens}, ctx_len=ctx)
        toks = torch.argmax(last, dim=-1)
        finite = bool(torch.isfinite(last).all())      # syncs the prefill
        t_dec = time.time()
        gen = server.generate(params, toks.cpu().numpy(), spec.T - 1,
                              start_pos=job.prompt_len, cache=cache)
        dt = time.time() - t_dec
        if server.logits_finite is not None:
            finite = finite and server.logits_finite
        gen = np.concatenate([toks.to(torch.int32).cpu().numpy()[:, None],
                              gen], axis=1)
        return RunResult(
            spec=spec, backend=self.name, x=gen, seconds=time.time() - t0,
            extra={"prompts": prompts, "arch": cfg.name,
                   "device": str(device),
                   "prefill_seconds": t_dec - t_pre,
                   "decode_seconds": dt,
                   "tok_per_s": job.batch * (spec.T - 1) / max(dt, 1e-9),
                   "logits_finite": finite,
                   "flash_launches": flash_kernel.launches - launches0})


def run(spec: ExperimentSpec, backend: Optional[Backend] = None,
        device="cuda") -> RunResult:
    """Execute a spec on the right backend (dispatched on the objective)."""
    if backend is None:
        if not isinstance(spec.objective, ServeJob):
            raise NotImplementedError(
                f"objective {type(spec.objective).__name__} is not ported "
                "yet; the trainer and simulator backends are later slices "
                "(ROADMAP.md queue 1)")
        backend = ServeBackend(device=device)
    return backend.run(spec)
