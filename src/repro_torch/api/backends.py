"""Execute an :class:`ExperimentSpec`.

Counterpart of ``repro/api/backends.py``:

* :class:`SimulatorBackend` — schedule + exact replay (theory tier) on the
  card: a grid stepsize policy replays every γ against ONE shared schedule
  in one loop of captured CUDA graph chunks
  (:func:`repro_torch.core.simulator.replay_grid`).
* :class:`TrainerBackend` — schedule → :class:`repro_torch.runtime.RunPlan`
  → ``AsyncTrainer`` rounds through the whole-run executor
  (``runtime="scan"``: K rounds per launch, or ``"eager"``: the per-round
  parity oracle).  Same schedulers as the JAX package, identical ordering
  and masks by construction.
* :class:`ServeBackend` — the lock-step lane: init params from the seed,
  draw the prompts with numpy (the same ``default_rng(seed)`` stream as the
  JAX package), prefill, take the first token by argmax, then decode
  ``T − 1`` steps through :class:`repro_torch.distributed.Server`; or, with
  ``ServeJob.n_slots`` set, the continuous-batching slot lane through
  :class:`repro_torch.distributed.SlotServer` on the same prompt stream.

The trainer and serve backends refuse a ``scenario``: its schedule side is
ported, but the per-round channels it lowers into a ``RunPlan`` (and the
serve faults) are not yet, and a run without them would not be the world
the spec asks for.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..core import (delay_adaptive_stepsizes, replay, replay_grid,
                    round_masks)
from ..core.trace import summarize
from ..device import resolve_device, synchronize
from ..kernels import async_update as update_kernels
from ..kernels import flash_attention as flash_kernel
from ..kernels import ssd_chunk as ssd_kernel
from .result import RunResult
from .spec import ExperimentSpec, ServeJob, StepsizePolicy, TrainJob


@runtime_checkable
class Backend(Protocol):
    name: str

    def run(self, spec: ExperimentSpec) -> RunResult: ...


def _refuse_scenario(spec: ExperimentSpec, backend: str) -> None:
    if spec.scenario is not None:
        raise NotImplementedError(
            f"the {backend} backend does not run scenario worlds yet: their "
            "RunPlan channels (availability, data drift, sparsity, faults) "
            "are not ported (ROADMAP.md queue 1, 'Copy scenarios/, faults/ "
            "and obs/'); the simulator backend runs their schedules")


def _canonical(device) -> torch.device:
    """``device`` with a CUDA device's index made explicit."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _grid_score(grad_norms: np.ndarray) -> float:
    """The paper's selection protocol (App. A.1): best final grad norm with
    small fluctuations — tail mean plus half the tail standard deviation."""
    tail = float(np.mean(grad_norms[-3:]))
    fluct = float(np.std(grad_norms[-5:]))
    return tail + 0.5 * fluct


class SimulatorBackend:
    """Exact replay of Algorithm 1: x_{t+1} = x_t − γ̃ g_{i_t}(x_{π_t}), on
    ``device`` (default CUDA).

    The objective's tensors must live on that device (nothing is moved:
    a mismatch raises).  x0 is zeros (f32); a stochastic spec draws its
    (T, bs) mini-batch table from a CPU ``torch.Generator`` seeded with
    ``spec.seed`` (the port's own stream) and copies it to the device once,
    so the CPU and the card replay the same noise.  ``capture=False`` runs
    the eager loop on the card (the graph route's parity oracle).

    ``RunResult.extra`` carries ``device``, ``runtime`` (``"graph"`` or
    ``"eager"``), ``graph_replays``, ``chunk_steps``, ``host_syncs`` (1 per
    run) and ``scenario``."""

    name = "simulator"

    def __init__(self, device="cuda", capture: bool = True):
        self.device = device
        self.capture = capture

    def run(self, spec: ExperimentSpec) -> RunResult:
        prob = spec.objective
        if prob is None or not hasattr(prob, "grad_fn"):
            raise TypeError(
                "SimulatorBackend needs an objective exposing grad_fn "
                f"(got {type(prob).__name__})")
        device = resolve_device(self.device)
        have = getattr(prob, "device", None)
        if have is None or _canonical(have) != _canonical(device):
            raise ValueError(
                f"the objective's tensors live on {have}, but the simulator "
                f"backend was asked to run on {device}; build the objective "
                f"with device={str(device)!r}")
        t0 = time.time()
        schedule = spec.build_schedule()
        grad_fn = prob.grad_fn(stochastic=spec.stochastic)
        full_grad = getattr(prob, "full_grad", None)
        loss = getattr(prob, "loss", None)
        x0 = np.zeros(prob.d, dtype=np.float32)
        batch_idx = None
        if spec.stochastic and hasattr(prob, "batch_table"):
            gen = torch.Generator().manual_seed(spec.seed)
            batch_idx = prob.batch_table(schedule.T, gen)
        policy: StepsizePolicy = spec.stepsize
        kw = dict(batch_idx=batch_idx, clip=spec.clip,
                  log_every=spec.log_every, full_grad_fn=full_grad,
                  loss_fn=loss, device=device, capture=self.capture)

        if policy.kind == "grid":
            if full_grad is None:
                raise ValueError(
                    "grid stepsize selection scores grad norms; the "
                    "objective must expose full_grad")
            results = replay_grid(schedule, grad_fn, x0, policy.gammas, **kw)
            best_i, best_score = 0, None
            grid_info = {}
            for i, (g, res) in enumerate(zip(policy.gammas, results)):
                score = _grid_score(res.grad_norms)
                grid_info[g] = {"grad_norms": res.grad_norms,
                                "losses": res.losses, "score": score}
                if best_score is None or score < best_score:
                    best_i, best_score = i, score
            gamma, res = policy.gammas[best_i], results[best_i]
        else:
            gamma = policy.gamma
            if policy.kind == "delay_adaptive":
                steps = delay_adaptive_stepsizes(gamma, schedule.delays,
                                                 schedule.tau_c())
            else:
                steps = gamma
            res = replay(schedule, grad_fn, x0, steps, **kw)
            grid_info = None

        return RunResult(
            spec=spec, backend=self.name, x=res.x, xs=res.xs,
            log_ts=res.log_ts, grad_norms=res.grad_norms, losses=res.losses,
            gamma=gamma, grid=grid_info, schedule=schedule,
            trace=summarize(schedule), seconds=time.time() - t0,
            extra={**res.stats, "scenario": spec.scenario})


class TrainerBackend:
    """Schedule → plan → ``AsyncTrainer`` rounds on ``device`` (default
    CUDA).

    ``on_step(i, state, metrics)`` is invoked once per round (at chunk
    boundaries on the scan runtime).  ``runtime`` / ``rounds_per_launch`` /
    ``metrics`` override the spec's fields; both unset falls back to
    ``"scan"`` / the spec's K / ``"chunk"``.  A grid stepsize policy runs
    the sequential loop (one run per γ, best tail loss wins).

    Two injection hooks replace the port's own random streams, so a test
    can hold a run to the JAX package's: ``params_fn(cfg, device)`` returns
    the initial params tree, and ``batch_fn(q)`` round q's batch dict.

    ``RunResult.x`` is the final state; ``extra`` carries the JAX keys the
    port can fill plus ``update_launches``, the launches of each update
    kernel during the run, and ``device``."""

    name = "trainer"
    default_runtime = "scan"
    default_metrics = "chunk"

    def __init__(self, device="cuda", on_step: Optional[Callable] = None,
                 runtime: Optional[str] = None,
                 rounds_per_launch: Optional[int] = None,
                 metrics: Optional[str] = None,
                 params_fn: Optional[Callable] = None,
                 batch_fn: Optional[Callable] = None):
        self.device = device
        self.on_step = on_step
        self.runtime = runtime
        self.rounds_per_launch = rounds_per_launch
        self.metrics = metrics
        self.params_fn = params_fn
        self.batch_fn = batch_fn

    @staticmethod
    def masks_for(spec: ExperimentSpec, n_groups: Optional[int] = None):
        """((rounds, n_groups) participation masks, realised Schedule) for
        ``spec.T`` rounds."""
        sched = spec.make_scheduler(n_groups)
        schedule = spec.build_schedule(T=spec.T * sched.wait_b, n=n_groups)
        return round_masks(schedule), schedule

    def resolve_runtime(self, spec: ExperimentSpec):
        """(runtime, rounds_per_launch, metrics): constructor overrides
        spec, both-unset → the scan/chunk defaults."""
        runtime = self.runtime or spec.runtime or self.default_runtime
        k = self.rounds_per_launch if self.rounds_per_launch is not None \
            else spec.rounds_per_launch
        metrics = self.metrics or spec.metrics or self.default_metrics
        return runtime, int(k), metrics

    def run(self, spec: ExperimentSpec) -> RunResult:
        job = spec.objective
        if not isinstance(job, TrainJob):
            raise TypeError("TrainerBackend needs a TrainJob objective")
        _refuse_scenario(spec, "trainer")
        policy: StepsizePolicy = spec.stepsize
        if policy.kind == "grid":
            best = None
            for g in policy.gammas:
                # scoring needs loss curves, so a metrics="none" resolution
                # is overridden
                res = self._run_single(spec, job, g, adaptive=False,
                                       metrics_floor="chunk")
                score = float(np.mean(res.losses[-3:]))
                if best is None or score < best[0]:
                    best = (score, res)
            return best[1]
        return self._run_single(spec, job, policy.gamma,
                                adaptive=policy.kind == "delay_adaptive")

    def _make_trainer(self, spec: ExperimentSpec, job: TrainJob, lr: float,
                      adaptive: bool, device):
        from ..distributed import AsyncConfig, AsyncTrainer
        from ..optim import OptConfig

        cfg = job.make_arch()
        tr = AsyncTrainer(
            cfg,
            opt=OptConfig(name=job.opt, lr=lr, clip_norm=job.clip_norm,
                          update_impl=job.update_impl),
            async_cfg=AsyncConfig(delay_rounds=job.delay_rounds,
                                  delay_adaptive=adaptive,
                                  microbatches=job.microbatches,
                                  guards=True if job.guards else None),
            device=device)
        n_groups = spec.n_workers or tr.n_groups
        tr.n_groups = n_groups
        if job.global_batch % n_groups:
            raise ValueError(
                f"the {n_groups} worker groups must divide "
                f"global_batch={job.global_batch}")
        return tr, cfg, n_groups

    def _run_single(self, spec: ExperimentSpec, job: TrainJob, lr: float,
                    adaptive: bool,
                    metrics_floor: Optional[str] = None) -> RunResult:
        """One (γ, adaptive) run.  ``metrics_floor`` replaces a resolved
        ``"none"`` with a curve-producing mode for callers that must read
        the losses back (grid scoring)."""
        from ..runtime import compile_plan, execute

        device = resolve_device(self.device)
        t0 = time.time()
        tr, cfg, n_groups = self._make_trainer(spec, job, lr, adaptive,
                                               device)
        masks, schedule = self.masks_for(spec, n_groups)
        params = self.params_fn(cfg, device) if self.params_fn else None
        state = tr.init_state(spec.seed, params=params)
        rounds = min(spec.T, masks.shape[0])
        plan = compile_plan(schedule, job, rounds=rounds, n_groups=n_groups,
                            seed=spec.seed, adaptive=adaptive)
        runtime, rounds_per_launch, metrics = self.resolve_runtime(spec)
        if metrics == "none" and metrics_floor is not None:
            metrics = metrics_floor
        before = dict(update_kernels.launches)
        exec_res = execute(tr, plan, state, runtime=runtime,
                           rounds_per_launch=rounds_per_launch,
                           metrics=metrics, on_step=self.on_step,
                           batch_fn=self.batch_fn)
        update_launches = {k: update_kernels.launches[k] - before[k]
                           for k in update_kernels.KERNELS}

        have_curves = bool(exec_res.metrics)
        return RunResult(
            spec=spec, backend=self.name, x=exec_res.state,
            log_ts=np.arange(rounds),
            losses=exec_res.metrics["loss"].astype(np.float64)
            if have_curves else None,
            grad_norms=exec_res.metrics["grad_norm"].astype(np.float64)
            if have_curves else None,
            gamma=lr, schedule=schedule, trace=summarize(schedule),
            seconds=time.time() - t0,
            extra={"metrics": exec_res.rows, "masks": masks,
                   "arch": cfg.name, "n_groups": n_groups,
                   "update_impl": tr.update_impl,
                   "delay_scales": plan.delay_scales if adaptive else None,
                   "scenario": spec.scenario,
                   "plan_summary": plan.summary(),
                   "runtime": runtime,
                   "rounds_per_launch": rounds_per_launch,
                   "metrics_mode": metrics if runtime == "scan" else "chunk",
                   "launches": exec_res.launches,
                   "host_syncs": exec_res.host_syncs,
                   "tap_events": exec_res.tap_events,
                   "update_launches": update_launches,
                   "device": str(device)})


class ServeBackend:
    """Prefill + lock-step batched decode on ``device`` (default CUDA), or
    the slot lane when ``ServeJob.n_slots`` is set.

    Lock-step: ``RunResult.x`` is the (batch, T) int32 token matrix;
    ``extra`` holds ``prompts``, ``arch``, ``prefill_seconds``,
    ``decode_seconds``, ``tok_per_s``, ``logits_finite``,
    ``flash_launches`` and ``ssd_launches`` (the flash and SSD kernels'
    launch counters read before and after the run).  The slot lane: see
    :meth:`_run_slots`."""

    name = "serve"

    def __init__(self, device="cuda"):
        self.device = device

    def run(self, spec: ExperimentSpec) -> RunResult:
        from ..distributed import Server, ServeConfig
        from ..models import init_params, prefill

        job = spec.objective
        if not isinstance(job, ServeJob):
            raise TypeError("ServeBackend needs a ServeJob objective")
        _refuse_scenario(spec, "serve")
        if job.n_slots:
            return self._run_slots(spec)
        device = resolve_device(self.device)
        t0 = time.time()
        launches0 = flash_kernel.launches, ssd_kernel.launches
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
                   "flash_launches": flash_kernel.launches - launches0[0],
                   "ssd_launches": ssd_kernel.launches - launches0[1]})

    def _run_slots(self, spec: ExperimentSpec) -> RunResult:
        """Continuous batching: ``n_requests`` requests through ``n_slots``
        ragged decode lanes; admissions follow the job's scheduler-registry
        policy, arrivals its timing-registry pattern.  ``RunResult.x`` is
        the (n_requests, T) token matrix (−1 where a request degraded);
        ``extra`` carries the JAX package's keys that the slot lane fills
        (``tau_report`` among them) plus ``device``, ``flash_launches``,
        ``ssd_launches``, ``graph_replays`` (chunk graph replays),
        ``host_waits``, ``chunk_device_ms`` and ``compile_counts``."""
        from ..distributed import (SlotServer, SlotConfig, draw_arrivals,
                                   parse_admission)
        from ..models import init_params
        from ..scenarios import tau_report

        job = spec.objective
        device = resolve_device(self.device)
        t0 = time.time()
        launches0 = flash_kernel.launches, ssd_kernel.launches
        cfg = job.make_arch()
        params = init_params(cfg, spec.seed, device)
        n_req = job.n_requests or job.batch
        ctx = job.prompt_len + spec.T
        server = SlotServer(
            cfg, SlotConfig(n_slots=job.n_slots, ctx_len=ctx,
                            temperature=job.temperature, seed=spec.seed,
                            steps_per_launch=job.steps_per_launch),
            device=device)
        # the lock-step lane's prompt stream: with n_requests == batch the
        # two lanes serve the same prompts
        prompts = np.random.default_rng(spec.seed).integers(
            0, cfg.vocab, (n_req, job.prompt_len)).astype(np.int32)
        arrivals = draw_arrivals(n_req, job.arrival, seed=spec.seed)
        synchronize(device)
        t_dec = time.time()
        res = server.serve(params, prompts, spec.T,
                           admission=job.admission, arrivals=arrivals,
                           deadline=job.deadline)
        dt = time.time() - t_dec
        return RunResult(
            spec=spec, backend=self.name, x=res.tokens,
            schedule=res.schedule, seconds=time.time() - t0,
            extra={"prompts": prompts, "arch": cfg.name,
                   "device": str(device),
                   "decode_seconds": dt,
                   "tok_per_s": n_req * (spec.T - 1) / max(dt, 1e-9),
                   "n_slots": job.n_slots, "admission": job.admission,
                   "arrivals": arrivals, "ttft_steps": res.ttft_steps,
                   "occupancy": res.occupancy,
                   "decode_steps": res.decode_steps, "chunks": res.chunks,
                   "tap_rows": res.tap_rows,
                   "evictions": res.evictions, "timeouts": res.timeouts,
                   "flash_launches": flash_kernel.launches - launches0[0],
                   "ssd_launches": ssd_kernel.launches - launches0[1],
                   "graph_replays": res.chunks if server.capture else 0,
                   "host_waits": res.host_waits,
                   "chunk_device_ms": res.chunk_device_ms,
                   "compile_counts": server.compile_counts(),
                   "tau_report": tau_report(
                       res.schedule, parse_admission(job.admission)[0],
                       concurrency=job.n_slots,
                       scenario_spec=job.arrival or "",
                       evictions=res.evictions, timeouts=res.timeouts)})


def run(spec: ExperimentSpec, backend: Optional[Backend] = None,
        device="cuda") -> RunResult:
    """Execute a spec on the right backend (dispatched on the objective),
    on ``device`` (default CUDA; raises when CUDA is absent)."""
    if backend is None:
        if isinstance(spec.objective, TrainJob):
            backend = TrainerBackend(device=device)
        elif isinstance(spec.objective, ServeJob):
            backend = ServeBackend(device=device)
        else:
            backend = SimulatorBackend(device=device)
    return backend.run(spec)
