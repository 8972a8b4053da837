"""Discrete-event engine: turns (scheduler, timing model) into a *schedule*.

Key observation exploited everywhere in this repo: under Algorithm 1 the
ordering (i_t, π_t) is fully determined by worker timings and the assignment
policy — it never depends on gradient *values*.  We therefore simulate the
cluster once (host-side, cheap) to obtain the schedule, and then *replay* the
schedule through the actual optimisation (a jittable `lax.scan`, see
``simulator.py``) or through the distributed trainer (round masks).

This mirrors the paper's framing: AsGrad is "SGD with an arbitrary data
ordering plus delays" (§1, §3.1).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .types import Job, Trace, UpdateRecord
from .delays import TimingModel
from .schedulers import Scheduler


@dataclasses.dataclass
class Schedule:
    """The realised ordering of Algorithm 1.

    ``workers[t] = i_t`` and ``assign_iters[t] = π_t`` define the update rule
    x_{t+1} = x_t − γ̃ g_{i_t}(x_{π_t}) with γ̃ = γ / wait_b.
    """

    workers: np.ndarray          # (T,) int32, i_t
    assign_iters: np.ndarray     # (T,) int32, π_t
    finish_times: np.ndarray     # (T,) float64 (simulated receive instants)
    active_jobs: np.ndarray      # (T,) int32, |A_{t+1} \ R_t| before update t
    unfinished_assign_iters: np.ndarray  # (k,) int32: j for (i,j) ∈ A_{T+1}\R_T
    wait_b: int
    n_workers: int

    @property
    def T(self) -> int:
        return int(self.workers.shape[0])

    @property
    def delays(self) -> np.ndarray:
        """τ_t = t − π_t."""
        return np.arange(self.T, dtype=np.int64) - self.assign_iters

    # ---- Definitions 1 & 2 of the paper -----------------------------------
    def tau_max(self) -> int:
        tail = self.T - self.unfinished_assign_iters if len(self.unfinished_assign_iters) else np.array([0])
        m = int(self.delays.max(initial=0))
        return max(m, int(tail.max(initial=0)))

    def tau_avg(self) -> float:
        total = float(self.delays.sum()) + float((self.T - self.unfinished_assign_iters).sum())
        n_assigned = self.T + len(self.unfinished_assign_iters)
        return total / max(n_assigned, 1)

    def tau_c(self) -> int:
        return int(self.active_jobs.max(initial=0))

    def jobs_per_worker(self) -> np.ndarray:
        return np.bincount(self.workers, minlength=self.n_workers)

    def to_trace(self) -> Trace:
        recs = [
            UpdateRecord(
                t=t,
                worker=int(self.workers[t]),
                assign_iter=int(self.assign_iters[t]),
                delay=int(t - self.assign_iters[t]),
                finish_time=float(self.finish_times[t]),
                active_jobs=int(self.active_jobs[t]),
            )
            for t in range(self.T)
        ]
        unfinished = [
            Job(worker=-1, assign_iter=int(j), assign_time=0.0)
            for j in self.unfinished_assign_iters
        ]
        return Trace(records=recs, unfinished=unfinished, n_workers=self.n_workers)


def build_schedule(scheduler: Scheduler, timing: TimingModel, T: int) -> Schedule:
    """Run Algorithm 1's job bookkeeping for ``T`` received gradients.

    Jobs queue FIFO at their worker (random assignment may hand a busy worker
    a second job — §3.2 "some workers might receive new jobs without
    completing the current one").
    """
    if timing.n_workers != scheduler.n:
        raise ValueError("scheduler and timing model disagree on n_workers")
    scheduler.reset()
    n = scheduler.n
    b = scheduler.wait_b

    #  per-worker state
    queues: list[list[Job]] = [[] for _ in range(n)]
    free_at = np.zeros(n, dtype=np.float64)
    heap: list[tuple[float, int, int]] = []   # (finish_time, job_id, worker)
    jobs: dict[int, Job] = {}
    job_counter = 0
    now = 0.0

    def _start(w: int, job: Job, start: float, duration: float) -> None:
        finish = start + duration
        jobs[job.job_id] = dataclasses.replace(job, finish_time=finish)
        heapq.heappush(heap, (finish, job.job_id, w))

    def maybe_start(w: int) -> None:
        """If the worker is idle and has a queued job, start it (scalar
        path — completion-triggered starts are one at a time)."""
        if queues[w] and free_at[w] >= 0:
            job = queues[w].pop(0)
            start = max(free_at[w], job.assign_time)
            free_at[w] = -1.0  # busy marker; real free time set on completion
            _start(w, job, start, timing.sample(w))

    def assign_batch(ws, alpha: int, at: float) -> None:
        """Assign jobs to ``ws`` in order; all jobs that start NOW get
        their compute times from ONE batched ``sample_round`` call.

        Job ids increment in assignment order and the batched draws are
        bit-identical to sequential scalar draws (delays.TimingModel), so
        the realised schedule — heap tie-breaks included — matches the
        old one-``assign``-at-a-time loop exactly.
        """
        nonlocal job_counter
        starts: list[tuple[int, Job, float]] = []
        for w in ws:
            job = Job(worker=w, assign_iter=alpha, assign_time=at,
                      job_id=job_counter)
            job_counter += 1
            queues[w].append(job)
            if free_at[w] >= 0:                 # idle → starts immediately
                j = queues[w].pop(0)
                start = max(free_at[w], j.assign_time)
                free_at[w] = -1.0
                starts.append((w, j, start))
        durations = timing.sample_round([w for w, _, _ in starts])
        for (w, j, start), d in zip(starts, durations):
            _start(w, j, start, float(d))

    assign_batch(scheduler.initial_workers(), 0, 0.0)

    workers = np.empty(T, dtype=np.int32)
    assign_iters = np.empty(T, dtype=np.int32)
    finish_times = np.empty(T, dtype=np.float64)
    active = np.empty(T, dtype=np.int32)

    t = 0
    round_finished: list[int] = []
    while t < T:
        if not heap:
            raise RuntimeError(
                f"deadlock at t={t}: no running jobs (scheduler {scheduler.name})"
            )
        finish, jid, w = heapq.heappop(heap)
        job = jobs.pop(jid)
        now = finish
        # active jobs BEFORE this receipt: everything assigned minus received
        n_active = len(heap) + 1 + sum(len(q) for q in queues)
        workers[t] = w
        assign_iters[t] = job.assign_iter
        finish_times[t] = finish
        active[t] = n_active
        free_at[w] = finish
        maybe_start(w)
        round_finished.append(w)
        t += 1
        if t % b == 0:
            assign_batch(scheduler.next_workers(round_finished), t, now)
            round_finished = []

    unfinished = [j.assign_iter for j in jobs.values()]
    for q in queues:
        unfinished.extend(j.assign_iter for j in q)
    return Schedule(
        workers=workers,
        assign_iters=assign_iters,
        finish_times=finish_times,
        active_jobs=active,
        unfinished_assign_iters=np.asarray(sorted(unfinished), dtype=np.int32),
        wait_b=b,
        n_workers=n,
    )


def round_masks(schedule: Schedule, n_rounds: int | None = None) -> np.ndarray:
    """(rounds, n) 0/1 participation masks for the distributed trainer.

    Round q aggregates the ``wait_b`` receipts t ∈ [q·b, (q+1)·b); a worker
    contributing k gradients in a round gets mask weight k.
    """
    b = schedule.wait_b
    total_rounds = schedule.T // b
    if n_rounds is None:
        n_rounds = total_rounds
    n_rounds = min(n_rounds, total_rounds)
    masks = np.zeros((n_rounds, schedule.n_workers), dtype=np.float32)
    # vectorized scatter: receipt t of round q = t // b contributes +1 to
    # (q, workers[t]); np.add.at accumulates duplicate (q, w) pairs
    w = schedule.workers[:n_rounds * b]
    q = np.repeat(np.arange(n_rounds), b)
    np.add.at(masks, (q, w), 1.0)
    return masks


def lower_rounds(schedule: Schedule, n_rounds: int | None = None, *,
                 delay_rounds: int = 0, adaptive: bool = False):
    """Lower a realised :class:`Schedule` to stacked per-round arrays.

    Returns ``(masks, delay_scales)``: the ``(rounds, n)`` participation
    masks and the ``(rounds,)`` stepsize scales — the delay-adaptive rule
    from :func:`round_delay_scales` when ``adaptive``, all-ones otherwise
    (so callers always have a dense per-round γ-scale to feed the traced
    step).  This is the schedule→plan lowering primitive the
    ``repro.runtime`` executor compiles against.
    """
    masks = round_masks(schedule, n_rounds)
    rounds = masks.shape[0]
    if adaptive:
        scales = round_delay_scales(schedule, rounds,
                                    delay_rounds=delay_rounds)
    else:
        scales = np.ones(rounds, dtype=np.float32)
    return masks, scales


def round_delay_scales(schedule: Schedule, n_rounds: int | None = None,
                       delay_rounds: int = 0) -> np.ndarray:
    """(rounds,) delay-adaptive stepsize scales from the realised schedule.

    The [Koloskova et al. 22]-style rule γ_t = γ·min(1, τ_C/(τ_t+1)) at
    round granularity: the gradient APPLIED at round q is scaled by the
    rule evaluated at its effective staleness.  ``delay_rounds`` is the
    REALISED buffering depth in rounds (AsyncTrainer's single
    swapped-every-round gbuf ⇒ 1 whenever its delay branch is active): the
    gradient applied at q was RECEIVED in round q − delay_rounds (mean
    receipt delay τ̄ over its ``wait_b`` receipts) and then buffered
    ``delay_rounds`` more rounds, so
    τ_applied(q) = τ̄_{q−delay_rounds} + delay_rounds.  The first
    ``delay_rounds`` rounds apply the (gated, empty) initial buffer and get
    a neutral scale of 1.  This is the per-round ``delay_scale`` input of
    ``AsyncTrainer.train_step_fn`` — computed host-side from schedule
    metadata, applied device-side inside the fused kernels."""
    b = schedule.wait_b
    total_rounds = schedule.T // b
    if n_rounds is None:
        n_rounds = total_rounds
    n_rounds = min(n_rounds, total_rounds)
    d = schedule.delays[:n_rounds * b].astype(np.float64)
    tau_round = d.reshape(n_rounds, b).mean(axis=1)
    if delay_rounds:
        shift = min(delay_rounds, n_rounds)
        shifted = np.empty_like(tau_round)
        shifted[:shift] = 0.0                  # → scale 1 (gated rounds)
        shifted[shift:] = tau_round[:n_rounds - shift] + delay_rounds
        tau_round = shifted
    tau_c = max(schedule.tau_c(), 1)
    return np.minimum(1.0, tau_c / (tau_round + 1.0)).astype(np.float32)
