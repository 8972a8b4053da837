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

A ``scenario`` runs as in the JAX package: the trainer backend realises
its world and lowers availability, data drift, sparsity and fault gains
into the ``RunPlan``; the slot lane lowers it to serve faults; the
lock-step serve lane, like JAX's, reads none of it.  Each backend takes a
``recorder`` (:class:`repro_torch.obs.Recorder`) whose summary rides
``RunResult.extra["obs"]``.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..core import (delay_adaptive_stepsizes, replay, replay_grid,
                    round_masks)
from ..core.trace import summarize
from ..device import resolve_device, synchronize
from ..distributed import collectives
from ..kernels import async_update as update_kernels
from ..kernels import flash_attention as flash_kernel
from ..kernels import ssd_chunk as ssd_kernel
from ..obs import CompileWatch
from .result import RunResult
from .spec import ExperimentSpec, ServeJob, StepsizePolicy, TrainJob


@runtime_checkable
class Backend(Protocol):
    name: str

    def run(self, spec: ExperimentSpec) -> RunResult: ...


def _obs(recorder, **extra):
    """The recorder's summary for ``RunResult.extra["obs"]`` (None without
    one)."""
    return recorder.summary(**extra) if recorder is not None else None


def _canonical(device) -> torch.device:
    """``device`` with a CUDA device's index made explicit."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _tree_index(tree, i: int):
    """Point ``i`` of a stacked ``(n_grid, ...)`` state, as new tensors."""
    if not isinstance(tree, dict):
        return tree[i].clone()
    return {k: _tree_index(v, i) for k, v in tree.items()}


def _mesh_extra(tr, coll: dict, rounds: int) -> dict:
    """The mesh keys of a trainer run's ``extra``: the mesh's axis sizes,
    the data ranks and each collective kind's ``[launches, bytes]`` a
    round."""
    return {"mesh": None if tr.mesh is None else dict(tr.mesh.shape),
            "ranks": tr.ranks,
            "collectives": {k: [n / max(rounds, 1), b / max(rounds, 1)]
                            for k, (n, b) in coll.items()}}


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
    run), ``scenario``, ``compile_counts`` (the backend's graph captures,
    cumulative over its runs) and ``obs``."""

    name = "simulator"

    def __init__(self, device="cuda", capture: bool = True, recorder=None):
        self.device = device
        self.capture = capture
        self.recorder = recorder
        self.watch = CompileWatch(recorder)

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
                  loss_fn=loss, device=device, capture=self.capture,
                  watch=self.watch)

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
            extra={**res.stats, "scenario": spec.scenario,
                   "compile_counts": self.watch.counts(),
                   "obs": _obs(self.recorder, rounds=spec.T)})


class TrainerBackend:
    """Schedule → plan → ``AsyncTrainer`` rounds on ``device`` (default
    CUDA).

    ``on_step(i, state, metrics)`` is invoked once per round (at chunk
    boundaries on the scan runtime under ``"chunk"``, per delivered row
    with ``state=None`` under ``"tap"``).  ``runtime`` /
    ``rounds_per_launch`` / ``metrics`` override the spec's fields; both
    unset falls back to ``"scan"`` / the spec's K / ``"chunk"``.

    A grid stepsize policy on the scan runtime runs every γ on one trainer
    over one plan with a γ-axis (:meth:`_run_grid`, the executor's
    :meth:`~repro_torch.runtime.PlanExecutor.run_grid`); the eager
    runtime, an ``on_step`` callback or a single γ keep the sequential
    loop (one run per γ), as in the JAX package.  Either way the best
    tail loss (mean of the last three rounds) wins.

    Two injection hooks replace the port's own random streams, so a test
    can hold a run to the JAX package's: ``params_fn(cfg, device)`` returns
    the initial params tree, and ``batch_fn(q)`` round q's batch dict.

    ``snapshot`` (a :class:`repro_torch.checkpoint.AsyncSnapshotter`) gives
    scan runs periodic asynchronous snapshots, as in the JAX package; the
    eager runtime takes none.  ``breaker`` (a
    :class:`repro_torch.faults.DivergenceBreaker`) trips through the tap
    lane: a scan run with ``metrics="tap"`` stops launching chunks once
    the loss diverges, and ``extra["tripped_round"]`` reports the trip.

    A spec's ``scenario`` realises its world (:meth:`world_for`) and feeds
    ``availability``, ``zipf_as``, ``grad_density`` and ``fault_gain`` into
    the plan, in the single run and in each run of the sequential grid;
    ``TrainJob(guards=True)`` arms the trainer's guard rails
    (``GuardConfig()``).  ``recorder`` traces the run (see
    :mod:`repro_torch.runtime.executor`).

    ``mesh`` (a bound ``launch.mesh.ProcessMesh``) and ``rules`` (default
    ``DEFAULT_RULES``) run the trainer over the mesh's data ranks, and
    tensor-parallel over its model axis for the dense and MoE families,
    as the JAX backend's ``mesh`` / ``rules`` do: every rank
    calls ``run`` with the same spec, and the worker groups default to
    the data-axis product when the spec names none.  The grid lane runs
    over the ranks too, and a snapshotter gathers the state at each
    offer (rank 0 writes).

    ``RunResult.x`` is the final state (this rank's, over ranks);
    ``extra`` carries the JAX keys the port can fill (``snapshots``, the
    offers, ``tripped_round``, ``scenario``, ``plan_summary`` and ``obs``
    among them; the grid lane adds ``grid_lane`` and ``n_grid``) plus
    ``update_launches``, the launches of each update kernel during the
    run, ``tap_waits``, ``device``, ``mesh`` (its axis sizes, or None),
    ``ranks`` and ``collectives``: each collective kind's launches and
    operand bytes a round (``[launches, bytes]``, the run's totals over
    its rounds; all zero without a mesh)."""

    name = "trainer"
    default_runtime = "scan"
    default_metrics = "chunk"

    def __init__(self, device="cuda", on_step: Optional[Callable] = None,
                 runtime: Optional[str] = None,
                 rounds_per_launch: Optional[int] = None,
                 metrics: Optional[str] = None,
                 params_fn: Optional[Callable] = None,
                 batch_fn: Optional[Callable] = None,
                 snapshot=None, breaker=None, recorder=None, mesh=None,
                 rules=None):
        self.device = device
        self.mesh = mesh
        self.rules = rules
        self.on_step = on_step
        self.runtime = runtime
        self.rounds_per_launch = rounds_per_launch
        self.metrics = metrics
        self.params_fn = params_fn
        self.batch_fn = batch_fn
        self.snapshot = snapshot
        self.breaker = breaker
        self.recorder = recorder

    @staticmethod
    def world_for(spec: ExperimentSpec, n_groups: Optional[int] = None):
        """The realised :class:`repro_torch.scenarios.ScenarioWorld` for
        ``spec.T`` rounds (the identity wrap when the spec has no scenario:
        the same schedule bit for bit as the stationary path)."""
        sched = spec.make_scheduler(n_groups)
        return spec.build_world(T=spec.T * sched.wait_b, n=n_groups)

    @staticmethod
    def masks_for(spec: ExperimentSpec, n_groups: Optional[int] = None):
        """((rounds, n_groups) participation masks, realised Schedule) for
        ``spec.T`` rounds.  The masks are the raw schedule lowering: elastic
        availability is folded in later, when the plan is compiled."""
        world = TrainerBackend.world_for(spec, n_groups)
        return round_masks(world.schedule), world.schedule

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
        policy: StepsizePolicy = spec.stepsize
        if policy.kind == "grid":
            runtime, _, _ = self.resolve_runtime(spec)
            # the grid lane has no per-round callback hook, so an on_step
            # consumer keeps the sequential loop
            if runtime == "scan" and len(policy.gammas) > 1 \
                    and self.on_step is None:
                return self._run_grid(spec, job)
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

    def state_shardings(self, spec: ExperimentSpec):
        """The ranked trainer's ``state_shardings()`` for ``spec`` (what the
        checkpointer takes to save or restore its state), or None without
        a mesh."""
        if self.mesh is None:
            return None
        tr, _, _ = self._make_trainer(spec, spec.objective, 1.0, False,
                                      resolve_device(self.device))
        return tr.state_shardings()

    def _make_trainer(self, spec: ExperimentSpec, job: TrainJob, lr: float,
                      adaptive: bool, device):
        from ..distributed import AsyncConfig, AsyncTrainer
        from ..distributed.sharding import DEFAULT_RULES
        from ..faults import GuardConfig
        from ..optim import OptConfig

        cfg = job.make_arch()
        tr = AsyncTrainer(
            cfg,
            opt=OptConfig(name=job.opt, lr=lr, clip_norm=job.clip_norm,
                          update_impl=job.update_impl),
            async_cfg=AsyncConfig(delay_rounds=job.delay_rounds,
                                  delay_adaptive=adaptive,
                                  microbatches=job.microbatches,
                                  guards=GuardConfig() if job.guards
                                  else None),
            device=device, mesh=self.mesh,
            rules=self.rules if self.rules is not None else DEFAULT_RULES)
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
        world = self.world_for(spec, n_groups)
        schedule = world.schedule
        masks = round_masks(schedule)
        params = self.params_fn(cfg, device) if self.params_fn else None
        state = tr.init_state(spec.seed, params=params)
        rounds = min(spec.T, masks.shape[0])
        plan = compile_plan(schedule, job, rounds=rounds, n_groups=n_groups,
                            seed=spec.seed, adaptive=adaptive,
                            availability=world.availability,
                            zipf_as=world.zipf_as,
                            grad_density=world.grad_density,
                            fault_gain=world.fault_gain)
        runtime, rounds_per_launch, metrics = self.resolve_runtime(spec)
        if metrics == "none" and metrics_floor is not None:
            metrics = metrics_floor
        kw = {}
        if runtime == "scan":           # durability / breaker: scan lanes
            kw = {"snapshot": self.snapshot, "breaker": self.breaker}
        before = dict(update_kernels.launches)
        coll = collectives.snapshot()
        exec_res = execute(tr, plan, state, runtime=runtime,
                           rounds_per_launch=rounds_per_launch,
                           metrics=metrics, on_step=self.on_step,
                           batch_fn=self.batch_fn, recorder=self.recorder,
                           **kw)
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
                   "tap_waits": exec_res.stats.tap_waits,
                   "snapshots": exec_res.stats.snapshots,
                   "tripped_round": exec_res.stats.tripped_round,
                   "update_launches": update_launches,
                   "obs": _obs(self.recorder, rounds=rounds),
                   "device": str(device),
                   **_mesh_extra(tr, collectives.since(coll), rounds)})

    def _run_grid(self, spec: ExperimentSpec, job: TrainJob) -> RunResult:
        """Every grid γ on one trainer built at γ_base = gammas[0], over
        one plan whose ``grid_scales`` rows fold each γ in; every point is
        scored by the sequential loop's tail-loss protocol, and the best
        point's final state is ``x``."""
        from ..runtime import PlanExecutor, compile_plan

        device = resolve_device(self.device)
        t0 = time.time()
        gammas = spec.stepsize.gammas
        tr, cfg, n_groups = self._make_trainer(spec, job, gammas[0], False,
                                               device)
        world = self.world_for(spec, n_groups)
        schedule = world.schedule
        masks = round_masks(schedule)
        rounds = min(spec.T, masks.shape[0])
        plan = compile_plan(schedule, job, rounds=rounds, n_groups=n_groups,
                            seed=spec.seed, grid_gammas=gammas,
                            availability=world.availability,
                            zipf_as=world.zipf_as,
                            grad_density=world.grad_density,
                            fault_gain=world.fault_gain)
        _, rounds_per_launch, _ = self.resolve_runtime(spec)
        params = self.params_fn(cfg, device) if self.params_fn else None
        ex = PlanExecutor(tr, plan, batch_fn=self.batch_fn,
                          recorder=self.recorder)
        before = dict(update_kernels.launches)
        # scoring needs curves, so the grid lane always reads them back
        # (one deferred read for the whole grid)
        res = ex.run_grid(tr.init_state(spec.seed, params=params),
                          rounds_per_launch=rounds_per_launch,
                          metrics="chunk", snapshot=self.snapshot)
        update_launches = {k: update_kernels.launches[k] - before[k]
                           for k in update_kernels.KERNELS}
        losses = res.metrics["loss"]              # (n_grid, rounds)
        gnorms = res.metrics["grad_norm"]
        scores = [float(np.mean(losses[i, -3:])) for i in range(len(gammas))]
        best = int(np.argmin(scores))
        grid_info = {g: {"losses": losses[i].astype(np.float64),
                         "grad_norms": gnorms[i].astype(np.float64),
                         "score": scores[i]}
                     for i, g in enumerate(gammas)}
        best_state = _tree_index(res.state, best)
        best_rows = [{k: float(res.metrics[k][best, q]) for k in res.metrics}
                     for q in range(rounds)]
        return RunResult(
            spec=spec, backend=self.name, x=best_state,
            log_ts=np.arange(rounds),
            losses=losses[best].astype(np.float64),
            grad_norms=gnorms[best].astype(np.float64),
            gamma=float(gammas[best]), grid=grid_info, schedule=schedule,
            trace=summarize(schedule), seconds=time.time() - t0,
            extra={"metrics": best_rows, "masks": masks,
                   "arch": cfg.name, "n_groups": n_groups,
                   "update_impl": tr.update_impl,
                   "delay_scales": None,
                   "scenario": spec.scenario,
                   "plan_summary": plan.summary(),
                   "runtime": "scan", "grid_lane": True,
                   "n_grid": len(gammas),
                   "rounds_per_launch": rounds_per_launch,
                   "metrics_mode": "chunk",
                   "launches": res.launches,
                   "host_syncs": res.host_syncs,
                   "tap_events": res.tap_events,
                   "tap_waits": res.stats.tap_waits,
                   "snapshots": res.stats.snapshots,
                   "tripped_round": res.stats.tripped_round,
                   "update_launches": update_launches,
                   "obs": _obs(self.recorder, rounds=rounds),
                   "device": str(device)})


class ServeBackend:
    """Prefill + lock-step batched decode on ``device`` (default CUDA), or
    the slot lane when ``ServeJob.n_slots`` is set.

    Lock-step: ``RunResult.x`` is the (batch, T) int32 token matrix;
    ``extra`` holds ``prompts``, ``arch``, ``prefill_seconds``,
    ``decode_seconds``, ``tok_per_s``, ``logits_finite``,
    ``flash_launches`` and ``ssd_launches`` (the flash and SSD kernels'
    launch counters read before and after the run) and ``obs`` (the
    ``recorder``'s summary: ``prefill`` and ``decode`` spans).  A
    ``scenario`` is read by the slot lane only, as in the JAX package.  The
    slot lane: see :meth:`_run_slots`.  The audio and vlm families raise
    ``NotImplementedError`` on both lanes before any parameter is made: a
    ``ServeJob`` has no modality inputs to give their prefill.

    ``mesh`` (a bound ``launch.mesh.ProcessMesh``) and ``rules`` serve the
    lock-step lane over the mesh, as the JAX ``Server`` does: every rank
    calls ``run`` with the same spec, the prompts' rows split over the data
    axes, the dense, ssm, hybrid and MoE families run tensor-parallel over
    the model axis (``distributed.Server``), and every rank returns the
    whole token matrix; ``extra`` adds ``mesh`` (its axis sizes) and
    ``collectives`` (each kind's ``[launches, bytes]`` over the run).  The
    slot lane runs over the mesh too (``SlotServer(mesh=...)``: each data
    rank holds a block of the slots, each rank its blocks of the params
    and the ragged cache), every rank returning the same token matrix and
    ``extra`` the same two keys."""

    name = "serve"

    def __init__(self, device="cuda", recorder=None, mesh=None, rules=None):
        self.device = device
        self.recorder = recorder
        self.mesh = mesh
        self.rules = rules

    def run(self, spec: ExperimentSpec) -> RunResult:
        from ..distributed import Server, ServeConfig
        from ..models import init_params, prefill

        job = spec.objective
        if not isinstance(job, ServeJob):
            raise TypeError("ServeBackend needs a ServeJob objective")
        family = job.make_arch().family
        if family in ("audio", "vlm"):
            # refused before any parameter is made: a ServeJob carries
            # token prompts only, and the JAX ServeBackend hands prefill no
            # frames or patches either (it fails on the missing key)
            raise NotImplementedError(
                f"ServeBackend serves token-only prompts; the {family!r} "
                f"family ({job.arch}) needs "
                f"{'frames' if family == 'audio' else 'patches'} for each "
                "prompt, which a ServeJob does not carry.  Serve it at the "
                "model level: repro_torch.models.prefill with the modality "
                "input, then Server.generate from that cache")
        if job.n_slots:
            return self._run_slots(spec)
        rec = self.recorder
        span = ((lambda name, **a: rec.span(name, "server", **a))
                if rec is not None else (lambda name, **a: nullcontext()))
        device = resolve_device(self.device)
        t0 = time.time()
        launches0 = flash_kernel.launches, ssd_kernel.launches
        coll = collectives.snapshot()
        cfg = job.make_arch()
        ctx = job.prompt_len + spec.T
        server = Server(cfg, ServeConfig(batch=job.batch, ctx_len=ctx,
                                         temperature=job.temperature,
                                         seed=spec.seed), device=device,
                        mesh=self.mesh, rules=self.rules)
        params = init_params(cfg, spec.seed, device,
                             shardings=server.param_shardings())
        prompts = np.random.default_rng(spec.seed).integers(
            0, cfg.vocab, (job.batch, job.prompt_len)).astype(np.int32)
        tokens = torch.as_tensor(prompts, dtype=torch.int64, device=device)
        run_prefill = prefill
        if self.mesh is not None:
            from ..distributed.sharding import sharded_trace

            tokens = server.batch_sharding().local(tokens)
            run_prefill = sharded_trace(prefill, self.mesh, self.rules)

        synchronize(device)
        t_pre = time.time()
        with span("prefill", batch=job.batch, plen=job.prompt_len):
            last, cache = run_prefill(cfg, params, {"tokens": tokens},
                                      ctx_len=ctx)
            toks = torch.argmax(last, dim=-1)
            if self.mesh is not None:
                toks = server.batch_sharding().gather(toks)
            finite = bool(torch.isfinite(last).all())  # syncs the prefill
        t_dec = time.time()
        with span("decode", steps=spec.T - 1):
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
                   "ssd_launches": ssd_kernel.launches - launches0[1],
                   "obs": _obs(rec, rounds=spec.T),
                   **({} if self.mesh is None else {
                       "mesh": dict(self.mesh.shape),
                       "collectives": collectives.since(coll)})})

    def _run_slots(self, spec: ExperimentSpec) -> RunResult:
        """Continuous batching: ``n_requests`` requests through ``n_slots``
        ragged decode lanes; admissions follow the job's scheduler-registry
        policy, arrivals its timing-registry pattern.  ``RunResult.x`` is
        the (n_requests, T) token matrix (−1 where a request degraded);
        ``extra`` carries the JAX package's keys that the slot lane fills
        (``tau_report`` with its degraded buckets among them) plus
        ``device``, ``flash_launches``, ``ssd_launches``, ``graph_replays``
        (chunk graph replays), ``host_waits``, ``chunk_device_ms`` and
        ``compile_counts``.  The job's resilience knobs build the
        :class:`RetryPolicy` and :class:`OverloadPolicy`, and the spec's
        scenario lowers to serve faults on the decode-step clock, as in
        the JAX package.  On a mesh ``extra`` adds ``mesh`` and
        ``collectives``, and every rank returns the same tokens."""
        from ..distributed import (SlotServer, SlotConfig, OverloadPolicy,
                                   RetryPolicy, draw_arrivals,
                                   parse_admission)
        from ..models import init_params
        from ..scenarios import tau_report

        job = spec.objective
        device = resolve_device(self.device)
        t0 = time.time()
        launches0 = flash_kernel.launches, ssd_kernel.launches
        coll = collectives.snapshot()
        cfg = job.make_arch()
        n_req = job.n_requests or job.batch
        ctx = job.prompt_len + spec.T
        server = SlotServer(
            cfg, SlotConfig(n_slots=job.n_slots, ctx_len=ctx,
                            temperature=job.temperature, seed=spec.seed,
                            steps_per_launch=job.steps_per_launch),
            device=device, recorder=self.recorder, mesh=self.mesh,
            rules=self.rules)
        params = init_params(cfg, spec.seed, device,
                             shardings=server.param_shardings())
        # the lock-step lane's prompt stream: with n_requests == batch the
        # two lanes serve the same prompts
        prompts = np.random.default_rng(spec.seed).integers(
            0, cfg.vocab, (n_req, job.prompt_len)).astype(np.int32)
        arrivals = draw_arrivals(n_req, job.arrival, seed=spec.seed)
        retry = (RetryPolicy(max_attempts=job.max_retries,
                             backoff_base=job.retry_backoff)
                 if job.max_retries > 1 else None)
        overload = (OverloadPolicy(job.queue_cap, job.shed_policy)
                    if job.queue_cap is not None else None)
        faults = None
        if spec.scenario:
            # slot_poison / serve_preempt cells realise on the decode-step
            # clock; training transforms contribute nothing
            from ..faults import realise_serve_faults

            fault_horizon = (2 * (int(arrivals.max(initial=0))
                                  + n_req * spec.T * job.max_retries
                                  + job.steps_per_launch)
                             + 4 * job.steps_per_launch)
            faults = realise_serve_faults(spec.scenario, n_req,
                                          fault_horizon, seed=spec.seed)
        synchronize(device)
        t_dec = time.time()
        res = server.serve(params, prompts, spec.T,
                           admission=job.admission, arrivals=arrivals,
                           deadline=job.deadline, retry=retry,
                           overload=overload, drain_after=job.drain_after,
                           faults=faults)
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
                   "shed": res.shed, "drained": res.drained,
                   "attempts": res.attempts,
                   "resumed_from": res.resumed_from,
                   "flash_launches": flash_kernel.launches - launches0[0],
                   "ssd_launches": ssd_kernel.launches - launches0[1],
                   "graph_replays": res.chunks if server.capture else 0,
                   "host_waits": res.host_waits,
                   "chunk_device_ms": res.chunk_device_ms,
                   "compile_counts": server.compile_counts(),
                   "obs": _obs(self.recorder, rounds=spec.T),
                   "tau_report": tau_report(
                       res.schedule, parse_admission(job.admission)[0],
                       concurrency=job.n_slots,
                       scenario_spec=job.arrival or "",
                       evictions=res.evictions, timeouts=res.timeouts,
                       shed=res.shed, drained=res.drained,
                       attempts=res.attempts),
                   **({} if self.mesh is None else {
                       "mesh": dict(self.mesh.shape),
                       "collectives": collectives.since(coll)})})


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
