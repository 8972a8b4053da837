"""Declarative experiment specs.

Counterpart of ``repro/api/spec.py``: :class:`TrainJob`, :class:`ServeJob`,
:class:`ExperimentSpec` and :class:`StepsizePolicy` with the same fields and
defaults, the ``constant`` / ``grid`` / ``delay_adaptive`` helpers, and the
same compact spec strings (scheduler ``"name[:k=v,...]"`` over
:data:`repro_torch.core.REGISTRY`, timing ``"pattern[:k=v,...]"``, scenario
in the :mod:`repro_torch.scenarios` grammar).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ..core import (TimingModel, build_schedule, heterogeneous_speeds,
                    make_scheduler)
from ..core.engine import Schedule
from ..core.schedulers import REGISTRY


def _parse_kv(text: str) -> dict:
    """``"b=4,reshuffle=0"`` → ``{"b": 4, "reshuffle": 0}`` (numbers coerced)."""
    out: dict[str, Any] = {}
    if not text:
        return out
    for item in text.split(","):
        if "=" not in item:
            raise ValueError(f"malformed spec option {item!r} (want key=value)")
        k, v = item.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def parse_compact(spec: str) -> tuple[str, dict]:
    """``"name:k=v,k=v"`` → ``(name, kwargs)``."""
    name, _, rest = spec.partition(":")
    return name, _parse_kv(rest)


@dataclasses.dataclass(frozen=True)
class StepsizePolicy:
    """How the server stepsize γ is chosen (``constant`` | ``grid`` |
    ``delay_adaptive``); see the JAX package for the policies."""

    kind: str = "constant"          # constant | grid | delay_adaptive
    gammas: tuple = (0.01,)

    KINDS = ("constant", "grid", "delay_adaptive")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown stepsize kind {self.kind!r}")
        object.__setattr__(self, "gammas",
                           tuple(float(g) for g in self.gammas))
        if not self.gammas:
            raise ValueError("stepsize policy needs at least one gamma")

    @property
    def gamma(self) -> float:
        return self.gammas[0]

    @classmethod
    def coerce(cls, value) -> "StepsizePolicy":
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            kind, _, rest = value.partition(":")
            gammas = tuple(float(g) for g in rest.split(",") if g)
            return cls(kind, gammas or (0.01,))
        if isinstance(value, (int, float)):
            return cls("constant", (float(value),))
        if isinstance(value, (tuple, list, np.ndarray)):
            return cls("grid", tuple(float(g) for g in value))
        raise TypeError(f"cannot coerce {value!r} to a StepsizePolicy")


def constant(gamma: float) -> StepsizePolicy:
    return StepsizePolicy("constant", (gamma,))


def grid(*gammas: float) -> StepsizePolicy:
    return StepsizePolicy("grid", tuple(gammas))


def delay_adaptive(gamma: float) -> StepsizePolicy:
    return StepsizePolicy("delay_adaptive", (gamma,))


@dataclasses.dataclass(frozen=True)
class TrainJob:
    """Objective for the trainer backend: arch + data for ``AsyncTrainer``.

    ``ExperimentSpec.T`` counts server *rounds* here (one aggregated model
    update per round); the schedule realises ``T·wait_b`` gradient receipts.
    ``update_impl``: ``"reference"`` (a tree of elementwise torch ops) or
    ``"pallas"`` / ``"pallas_interpret"`` (the fused update kernels, one
    per param leaf: CUDA on the card, their plain versions on the CPU)
    or ``"pallas_pooled"`` / ``"pallas_pooled_interpret"`` (the same
    kernels, one launch per dtype pool over the pooled state of
    :mod:`repro_torch.optim.pool`).  ``remat="full"`` recomputes each
    layer's activations in the backward pass.  ``guards=True`` arms
    the trainer's guard rails, ``AsyncConfig(guards=GuardConfig())``: a
    round whose loss or raw gradient norm is not finite is skipped on the
    device, and a per-worker health vector backs the stepsize off.
    """

    arch: str = "qwen2-0.5b"
    reduced: bool = True
    remat: Optional[str] = "none"
    arch_overrides: tuple = ()          # ((field, value), ...)
    global_batch: int = 8
    seq_len: int = 64
    heterogeneity: float = 1.0
    delay_rounds: int = 1               # 0 = synchronous baseline
    microbatches: int = 1
    opt: str = "adam"
    clip_norm: Optional[float] = 1.0
    update_impl: str = "reference"
    guards: bool = False

    def make_arch(self):
        from ..configs import get_arch
        cfg = get_arch(self.arch)
        if self.reduced:
            cfg = cfg.reduced()
        if self.remat is not None:
            cfg = cfg.with_(remat=self.remat)
        if self.arch_overrides:
            cfg = cfg.with_(**dict(self.arch_overrides))
        return cfg


@dataclasses.dataclass(frozen=True)
class ServeJob:
    """Objective for the serve backend: batched greedy/temperature decoding.

    ``ExperimentSpec.T`` counts decode steps (per-request token budget).

    Two serving modes share this job:

    * lock-step (default, ``n_slots=None``) — a fixed batch decodes in
      unison through :class:`repro_torch.distributed.Server`;
    * continuous batching (``n_slots`` set) — ``n_requests`` requests flow
      through ``n_slots`` persistent decode lanes
      (:class:`repro_torch.distributed.SlotServer`); ``admission`` picks
      which queued request fills a freed slot (scheduler-registry compact
      spec, e.g. ``"pure"`` / ``"fedbuff:b=2"``) and ``arrival`` draws
      inter-arrival gaps from the timing registry (``"pattern[:gap=G]"``;
      ``None`` = every request queued at step 0); ``deadline`` is a
      queue-wait budget in decode steps.  The resilience knobs: retries
      (``max_retries`` attempts, backoff base ``retry_backoff`` steps), a
      bounded queue (``queue_cap`` under ``shed_policy``) and a graceful
      drain (``drain_after``); ``ExperimentSpec.scenario`` lowers to serve
      faults (``slot_poison``, ``serve_preempt``) on this lane.

    The fields are validated as in the JAX package.
    """

    arch: str = "qwen2-0.5b"
    reduced: bool = True
    batch: int = 4
    prompt_len: int = 12
    temperature: float = 0.0
    arch_overrides: tuple = ()          # ((field, value), ...)
    n_slots: Optional[int] = None       # set → continuous-batching lane
    n_requests: Optional[int] = None    # default: batch
    admission: str = "pure"             # scheduler-registry compact spec
    arrival: Optional[str] = None       # timing-registry "pattern[:gap=G]"
    steps_per_launch: int = 8           # decode steps per chunk launch
    deadline: Optional[int] = None
    max_retries: int = 1
    retry_backoff: int = 4              # backoff base, in decode steps
    queue_cap: Optional[int] = None
    shed_policy: str = "reject-new"     # "reject-new" | "drop-oldest"
    drain_after: Optional[int] = None

    def __post_init__(self):
        if self.n_slots is not None and self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if self.steps_per_launch < 1:
            raise ValueError("steps_per_launch must be >= 1")
        for knob, val in (("deadline", self.deadline),
                          ("queue_cap", self.queue_cap),
                          ("drain_after", self.drain_after)):
            if val is not None and self.n_slots is None:
                raise ValueError(
                    f"{knob} is a slot-lane knob; set n_slots as well")
        if self.deadline is not None and self.deadline < 0:
            raise ValueError("deadline must be >= 0")
        if self.drain_after is not None and self.drain_after < 0:
            raise ValueError("drain_after must be >= 0")
        if self.max_retries < 1:
            raise ValueError("max_retries must be >= 1 (1 = no retry)")
        if self.max_retries > 1 and self.n_slots is None:
            raise ValueError(
                "max_retries is a slot-lane knob; set n_slots as well")
        if self.retry_backoff < 0:
            raise ValueError("retry_backoff must be >= 0")
        from ..distributed.slot_serve import OverloadPolicy, SHED_POLICIES
        if self.queue_cap is not None:
            OverloadPolicy(self.queue_cap, self.shed_policy)
        elif self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"unknown shed policy {self.shed_policy!r}")
        from ..distributed.admission import draw_arrivals, parse_admission
        parse_admission(self.admission)     # fail fast on grammar errors
        if self.arrival:
            draw_arrivals(1, self.arrival)

    def make_arch(self):
        from ..configs import get_arch
        cfg = get_arch(self.arch)
        if self.reduced:
            cfg = cfg.reduced().with_(remat="none")
        if self.arch_overrides:
            cfg = cfg.with_(**dict(self.arch_overrides))
        return cfg


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment, declaratively (fields and defaults as in the JAX
    package).  ``T`` counts received gradients on the simulator backend,
    server rounds on the trainer backend and decode steps on the serve
    backend; ``seed`` seeds the schedule, the mini-batch table, the params
    and the data (or prompts and sampling).  ``scenario`` wraps the
    scheduler and timing model in the world's transforms before the
    schedule is realised (``None``: the stationary world; ``""``: the
    identity scenario, the same schedule bit for bit)."""

    RUNTIMES = (None, "scan", "eager")
    METRIC_MODES = (None, "chunk", "tap", "none")

    scheduler: str = "pure"
    timing: str = "fixed:slow=5"
    objective: Any = None
    T: int = 1000
    n_workers: Optional[int] = None     # default: objective.n
    stepsize: Any = 0.01                # coerced to StepsizePolicy
    stochastic: bool = False
    clip: Optional[float] = None
    log_every: int = 100
    speeds: Optional[tuple] = None      # explicit per-worker speeds override
    seed: int = 0
    runtime: Optional[str] = None       # None → backend default ("scan")
    rounds_per_launch: int = 8          # scan runtime: K rounds per launch
    metrics: Optional[str] = None       # None → backend default ("chunk")
    scenario: Optional[str] = None      # None → stationary world

    def __post_init__(self):
        object.__setattr__(self, "stepsize",
                           StepsizePolicy.coerce(self.stepsize))
        if self.runtime not in self.RUNTIMES:
            raise ValueError(
                f"unknown runtime {self.runtime!r}; want one of "
                f"{[r for r in self.RUNTIMES if r]} (or None)")
        if self.metrics not in self.METRIC_MODES:
            raise ValueError(
                f"unknown metrics mode {self.metrics!r}; want one of "
                f"{[m for m in self.METRIC_MODES if m]} (or None)")
        if self.rounds_per_launch < 1:
            raise ValueError("rounds_per_launch must be >= 1")
        if self.speeds is not None:
            object.__setattr__(self, "speeds",
                               tuple(float(s) for s in self.speeds))
        name, _ = parse_compact(self.scheduler)
        if name not in REGISTRY:
            raise ValueError(
                f"unknown scheduler {name!r}; want one of {sorted(REGISTRY)}")
        if self.scenario is not None:
            from ..scenarios import parse_scenario
            parse_scenario(self.scenario)   # fail fast on grammar errors

    # ---- resolved pieces ---------------------------------------------------
    @property
    def n(self) -> int:
        if self.n_workers is not None:
            return int(self.n_workers)
        n = getattr(self.objective, "n", None)
        if n is None:
            raise ValueError(
                "n_workers not set and objective does not define .n")
        return int(n)

    def make_scheduler(self, n: Optional[int] = None):
        name, kw = parse_compact(self.scheduler)
        b = int(kw.pop("b", 1))
        return make_scheduler(name, n or self.n, b=b, seed=self.seed, **kw)

    def make_timing(self, n: Optional[int] = None) -> TimingModel:
        pattern, kw = parse_compact(self.timing)
        n = n or self.n
        slow = float(kw.pop("slow", 5.0))
        base = float(kw.pop("base", 1.0))
        if kw:
            raise ValueError(f"unknown timing options {sorted(kw)}")
        if self.speeds is not None:    # explicit profile overrides slow/base
            if len(self.speeds) != n:
                raise ValueError("speeds length must equal n_workers")
            speeds = np.asarray(self.speeds)
        else:
            speeds = heterogeneous_speeds(n, slow_factor=slow, base=base)
        return TimingModel(speeds, pattern, seed=self.seed)

    def make_scenario(self):
        """The parsed :class:`repro_torch.scenarios.Scenario` (empty when
        the spec has none — the identity scenario)."""
        from ..scenarios import parse_scenario
        return parse_scenario(self.scenario or "")

    def build_world(self, T: Optional[int] = None,
                    n: Optional[int] = None):
        """Realise the (possibly non-stationary) world for this spec: the
        scenario-wrapped schedule plus the per-round channels.  With no
        scenario this is the identity wrap — the same schedule bit for bit
        as :meth:`build_schedule`."""
        from ..scenarios import realise_world
        sched = self.make_scheduler(n)
        return realise_world(self.make_scenario(), sched,
                             self.make_timing(n), T or self.T,
                             seed=self.seed)

    def build_schedule(self, T: Optional[int] = None,
                       n: Optional[int] = None) -> Schedule:
        """Realise the ordering (i_t, π_t) for this spec (through the
        scenario wrap when one is set)."""
        if self.scenario is not None:
            return self.build_world(T, n).schedule
        sched = self.make_scheduler(n)
        return build_schedule(sched, self.make_timing(n), T or self.T)
