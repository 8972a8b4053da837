"""Declarative experiment specs (serving slice).

Counterpart of ``repro/api/spec.py``: :class:`ServeJob`,
:class:`ExperimentSpec` and :class:`StepsizePolicy` with the same fields and
defaults.  This slice runs the lock-step serving lane only:

* a :class:`ServeJob` that sets ``n_slots`` or any other slot-lane knob
  raises ``NotImplementedError`` (the slot server is a later slice);
* the scheduler, timing and scenario fields are kept so one spec object
  reads the same in both packages, but their validation and realisation
  arrive with ``core`` in the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


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


#: ServeJob fields that only the continuous-batching slot lane reads
SLOT_LANE_FIELDS = ("n_slots", "n_requests", "admission", "arrival",
                    "steps_per_launch", "deadline", "max_retries",
                    "retry_backoff", "queue_cap", "shed_policy",
                    "drain_after")


@dataclasses.dataclass(frozen=True)
class ServeJob:
    """Objective for the serve backend: batched greedy/temperature decoding.

    ``ExperimentSpec.T`` counts decode steps (per-request token budget).
    Only the lock-step lane (``n_slots=None``) is ported: a fixed batch
    decodes in unison through :class:`repro_torch.distributed.Server`.
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
        for f in dataclasses.fields(self):
            if f.name in SLOT_LANE_FIELDS and getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"ServeJob.{f.name} is a knob of the continuous-batching "
                    "slot lane, which is a later slice of the port "
                    "(ROADMAP.md queue 1, 'The rest of serving'); only the "
                    "lock-step lane runs here")

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
    package).  On the serve backend ``T`` counts decode steps and ``seed``
    seeds the params, the prompts and the sampling generator."""

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
