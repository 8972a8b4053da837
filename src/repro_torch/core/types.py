"""Core data types shared by the exact simulator and the distributed trainer."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Job:
    """A job (i, j): worker ``i`` computes grad f_i at model iterate ``j``.

    ``assign_iter`` is the server iteration α at which the job was assigned
    (the gradient is evaluated at x_α); ``assign_time``/``finish_time`` are
    simulated wall-clock instants.
    """

    worker: int
    assign_iter: int
    assign_time: float
    finish_time: float = float("inf")
    job_id: int = -1


@dataclasses.dataclass
class UpdateRecord:
    """One server update x_{t+1} = x_t − γ g_{i_t}(x_{π_t})."""

    t: int                 # server iteration index of the update
    worker: int            # i_t
    assign_iter: int       # π_t
    delay: int             # τ_t = t − π_t
    finish_time: float     # simulated receive instant
    active_jobs: int       # |A_{t+1} \ R_t| right before the update


@dataclasses.dataclass
class Trace:
    """Everything the theory (Defs 1–4) needs, recorded by the simulator."""

    records: list                    # list[UpdateRecord]
    unfinished: list                 # list[Job] = A_{T+1} \ R_T
    n_workers: int
    grad_norm_log: list = dataclasses.field(default_factory=list)  # (t, ||∇f(x_t)||)
    loss_log: list = dataclasses.field(default_factory=list)       # (t, f(x_t))
    wallclock: float = 0.0

    @property
    def T(self) -> int:
        return len(self.records)

    def worker_sequence(self):
        return [r.worker for r in self.records]

    def delays(self):
        return [r.delay for r in self.records]


@dataclasses.dataclass
class SimResult:
    x: object                  # final iterate
    trace: Trace
    best_grad_norm: float
    final_grad_norm: float
    history: Optional[list] = None   # optional iterate snapshots [(t, x)]
