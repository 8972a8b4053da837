"""Whole-run executor: the plan's rounds on the device, two dispatch modes.

Counterpart of ``repro/runtime/executor.py``.  Both runtimes replay the
same :class:`RunPlan` through the same train step; masks and delay scales
live on the device for the whole run and batches are synthesised there from
the plan's tables, so no round ships data from the host.

* ``"scan"`` (:meth:`PlanExecutor.run_scan`) — ``rounds_per_launch`` (K)
  rounds are issued back to back as one launch; their metric rows are
  stacked on the device.  Metrics mode ``"chunk"`` reads the stack back at
  each chunk boundary when an ``on_step`` callback wants the values, and
  otherwise once for the whole run at its end; ``"none"`` discards them.
  PyTorch runs eagerly, so a "launch" here is a chunk of rounds the host
  enqueues without waiting; a CUDA graph over a round is a later slice.
* ``"eager"`` (:meth:`PlanExecutor.run_eager`) — one round per launch and
  one host read of its metric row per round: the parity oracle.

``launches`` and ``host_syncs`` count as in the JAX package: a launch per
chunk (scan) or per round (eager); a host sync per blocking metric read.
``run_scan(snapshot=...)`` offers the end-of-chunk state to a
:class:`repro_torch.checkpoint.AsyncSnapshotter` at its due boundaries and
drains it at the end of the run; a restored state resumes through
``start_round``.  Not ported yet: the ``"tap"`` transport, the vmapped
γ-grid lane and the divergence breaker (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..device import synchronize
from .plan import RunPlan

#: fixed metric order of the on-device metric row; mirrors the dict
#: returned by ``AsyncTrainer.train_step_fn``
METRICS = ("loss", "ce", "aux", "grad_norm", "participation",
           "skipped", "gscale")

#: metric transport modes of the scan executor that are ported
METRIC_MODES = ("chunk", "none")


@dataclasses.dataclass
class ExecStats:
    """Dispatch accounting: ``launches`` (chunks on the scan runtime,
    rounds on the eager one), ``host_syncs`` (times the host blocked on
    a metric read mid-run or at its end) and ``snapshots`` (offers to the
    snapshotter); ``tap_events`` stays 0 until the tap lane is ported."""

    launches: int = 0
    host_syncs: int = 0
    tap_events: int = 0
    snapshots: int = 0


@dataclasses.dataclass
class ExecResult:
    """Final state + per-round metric curves (host numpy)."""

    state: object
    metrics: dict
    stats: ExecStats = dataclasses.field(default_factory=ExecStats)

    @property
    def launches(self) -> int:
        return self.stats.launches

    @property
    def host_syncs(self) -> int:
        return self.stats.host_syncs

    @property
    def tap_events(self) -> int:
        return self.stats.tap_events

    @property
    def rows(self) -> list:
        """Metrics as one dict per round."""
        if not self.metrics:
            return []
        first = next(iter(self.metrics.values()))
        return [{k: float(v[i]) for k, v in self.metrics.items()}
                for i in range(len(first))]


def make_batch_fn(plan: RunPlan, cfg, device) -> Callable:
    """``batch_of(q) -> batch dict``, drawn on ``device``.

    Tokens: inverse-CDF Zipf draws (``searchsorted`` on the plan's
    cumulative pmf) pushed through each group's vocab permutation, the law
    of the JAX package's device synthesis.  The uniforms come from a
    ``torch.Generator`` on ``device`` seeded with ``plan.data_keys[q]``:
    torch's stream, not JAX's."""
    from ..models import batch_specs

    specs = batch_specs(cfg, plan.global_batch, plan.seq_len)
    cdf = torch.as_tensor(plan.token_cdf, device=device)
    perms = torch.as_tensor(plan.group_perms, dtype=torch.int64,
                            device=device)
    per = plan.global_batch // plan.n_groups
    gidx = torch.arange(plan.n_groups, device=device).repeat_interleave(per)

    def batch_of(q: int) -> dict:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(plan.data_keys[q]))
        out = {}
        for k, sp in sorted(specs.items()):
            u = torch.rand((plan.global_batch, sp.shape[1]), generator=gen,
                           device=device)
            ranks = torch.searchsorted(cdf, u).clamp_(0, cdf.shape[0] - 1)
            out[k] = perms[gidx[:, None], ranks]
        return out

    return batch_of


def _row_dict(row) -> dict:
    return {k: float(v) for k, v in zip(METRICS, row)}


def _chunk_bounds(rounds: int, rounds_per_launch: int, start: int):
    k = max(int(rounds_per_launch), 1)
    lo = start
    while lo < rounds:
        hi = min(lo + k, rounds)
        yield lo, hi
        lo = hi


def _curves(all_ms: np.ndarray) -> dict:
    return {k: all_ms[:, j] for j, k in enumerate(METRICS)}


class PlanExecutor:
    """One (trainer × plan) on the trainer's device.

    ``batch_fn(q) -> dict`` replaces the on-device synthesis (tests inject
    the JAX package's batches through it); its arrays are moved to the
    device each round."""

    def __init__(self, trainer, plan: RunPlan, *,
                 batch_fn: Optional[Callable] = None):
        self.trainer = trainer
        self.plan = plan
        self.device = trainer.device
        if batch_fn is None:
            self._batch_of = make_batch_fn(plan, trainer.cfg, self.device)
        else:
            self._batch_of = lambda q: {
                k: torch.as_tensor(np.array(v), device=self.device)
                for k, v in batch_fn(q).items()}
        self._step = trainer.train_step_fn()
        self._masks = torch.as_tensor(plan.masks, device=self.device)
        self._scales = torch.as_tensor(plan.delay_scales, device=self.device)

    def _round(self, state, q: int):
        """Round q: its batch, its mask, its scale (adaptive plans only: a
        neutral plan leaves the trainer's static delay rule in charge) →
        (state, metric row on the device)."""
        kw = {"delay_scale": self._scales[q]} if self.plan.adaptive else {}
        state, m = self._step(state, self._batch_of(q), self._masks[q], **kw)
        return state, torch.stack([m[k].to(torch.float32) for k in METRICS])

    def _maybe_snapshot(self, snapshot, hi: int, state, stats) -> None:
        """Offer the end-of-chunk state when ``hi`` is a due boundary: the
        offer queues a device copy and its host fetch and returns, so the
        next chunk launches at once."""
        if snapshot is not None and snapshot.due(hi, self.plan.rounds):
            snapshot.offer(hi, state)
            stats.snapshots += 1

    def run_scan(self, state, *, rounds_per_launch: int = 8,
                 metrics: str = "chunk", on_step: Optional[Callable] = None,
                 start_round: int = 0, snapshot=None) -> ExecResult:
        """Rounds ``[start_round, rounds)``, K = ``rounds_per_launch`` per
        launch.  ``on_step(i, state, metrics_i)`` fires for every round at
        chunk boundaries with the end-of-chunk state (``"chunk"`` only).
        ``snapshot`` (an :class:`~repro_torch.checkpoint.AsyncSnapshotter`)
        is offered the state at every due chunk boundary and drained at the
        end; the batches are a pure function of (seed, round), so a state
        restored from round r and run from ``start_round=r`` ends as the
        uninterrupted run does."""
        if metrics == "tap":
            raise NotImplementedError(
                'metrics="tap" (per-round streaming) is not ported yet '
                '(ROADMAP.md queue 1); use "chunk" or "none"')
        if metrics not in METRIC_MODES:
            raise ValueError(f"unknown metrics mode {metrics!r}; want one "
                             f"of {METRIC_MODES}")
        if metrics == "none" and on_step is not None:
            raise ValueError('metrics="none" discards metrics on device; an '
                             'on_step callback would never fire')
        stats = ExecStats()
        chunks = []
        for lo, hi in _chunk_bounds(self.plan.rounds, rounds_per_launch,
                                    start_round):
            rows = []
            for q in range(lo, hi):
                state, row = self._round(state, q)
                rows.append(row)
            stats.launches += 1
            self._maybe_snapshot(snapshot, hi, state, stats)
            if metrics == "none":
                continue
            ms = torch.stack(rows)                   # (K, n_metrics), device
            if on_step is not None:
                ms = ms.cpu().numpy()                # blocking read per chunk
                stats.host_syncs += 1
                for i in range(lo, hi):
                    on_step(i, state, _row_dict(ms[i - lo]))
            chunks.append(ms)
        if snapshot is not None:
            snapshot.drain()
        if metrics == "none":
            synchronize(self.device)                 # completion barrier
            return ExecResult(state=state, metrics={}, stats=stats)
        if on_step is None and chunks:
            chunks = [torch.cat(chunks).cpu().numpy()]   # one deferred read
            stats.host_syncs = 1
        synchronize(self.device)
        all_ms = np.concatenate(chunks, axis=0) if chunks else \
            np.zeros((0, len(METRICS)), np.float32)
        return ExecResult(state=state, metrics=_curves(all_ms), stats=stats)

    def run_eager(self, state, *, on_step: Optional[Callable] = None,
                  start_round: int = 0) -> ExecResult:
        """The parity oracle: one launch and one host read per round."""
        stats = ExecStats()
        rows = []
        for q in range(start_round, self.plan.rounds):
            state, row = self._round(state, q)
            stats.launches += 1
            row = row.cpu().numpy()                  # host sync per round
            stats.host_syncs += 1
            rows.append(row)
            if on_step is not None:
                on_step(q, state, _row_dict(row))
        all_ms = np.stack(rows) if rows else \
            np.zeros((0, len(METRICS)), np.float32)
        return ExecResult(state=state, metrics=_curves(all_ms), stats=stats)


def run_scan(trainer, plan: RunPlan, state, *, rounds_per_launch: int = 8,
             metrics: str = "chunk", on_step: Optional[Callable] = None,
             start_round: int = 0, batch_fn=None,
             snapshot=None) -> ExecResult:
    return PlanExecutor(trainer, plan, batch_fn=batch_fn).run_scan(
        state, rounds_per_launch=rounds_per_launch, metrics=metrics,
        on_step=on_step, start_round=start_round, snapshot=snapshot)


def run_eager(trainer, plan: RunPlan, state, *,
              on_step: Optional[Callable] = None, start_round: int = 0,
              batch_fn=None) -> ExecResult:
    return PlanExecutor(trainer, plan, batch_fn=batch_fn).run_eager(
        state, on_step=on_step, start_round=start_round)


RUNTIMES = {"scan": run_scan, "eager": run_eager}


def execute(trainer, plan: RunPlan, state, *, runtime: str = "scan",
            rounds_per_launch: int = 8, metrics: str = "chunk",
            **kw) -> ExecResult:
    """Dispatch on ``runtime`` (``"scan"`` | ``"eager"``).  ``metrics``
    applies to the scan runtime only: eager reads every round back."""
    if runtime not in RUNTIMES:
        raise ValueError(
            f"unknown runtime {runtime!r}; want one of {sorted(RUNTIMES)}")
    if runtime == "scan":
        kw["rounds_per_launch"] = rounds_per_launch
        kw["metrics"] = metrics
    return RUNTIMES[runtime](trainer, plan, state, **kw)
