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
``start_round``.

A plan's scenario channels ride each round: the drifting data law picks
the round's row of the device-resident CDF bank (its index is a host
value, since the round loop is on the host), and the round passes its
keep-density (a host number) and its per-worker fault gains (a device
row) to the step.  A density forces the explicit-scale step, as in the
JAX executor.

``recorder`` (a :class:`repro_torch.obs.Recorder`) traces the run at host
boundaries that exist anyway, and never adds a device sync: ``launch``
spans around the enqueue of each chunk (or eager round), ``host_sync``
spans around the metric reads, a ``barrier`` span around the completion
wait, ``snapshot_offer`` spans, the counters of :class:`ExecStats`, and,
from the metric rows once they are on the host, a ``guard_skip`` instant
per skipped round and a ``gscale`` gauge per round whose health scale is
not 1.  On the card a span measures host enqueue time, not device time.
Without a recorder nothing is traced and nothing is paid.

Not ported yet: the ``"tap"`` transport, the vmapped γ-grid lane and the
divergence breaker (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
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

_SKIP_IDX = METRICS.index("skipped")
_GSCALE_IDX = METRICS.index("gscale")


def _span(rec, name, lane, **args):
    """A recorder span, or nothing without a recorder (an un-observed run
    pays nothing on the dispatch path)."""
    return rec.span(name, lane, **args) if rec is not None else nullcontext()


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
    of the JAX package's device synthesis.  On a drifting plan round q
    draws from ``cdf_bank[cdf_index[q]]`` (the bank lives on the device,
    the index is read on the host).  The uniforms come from a
    ``torch.Generator`` on ``device`` seeded with ``plan.data_keys[q]``:
    torch's stream, not JAX's."""
    from ..models import batch_specs

    specs = batch_specs(cfg, plan.global_batch, plan.seq_len)
    cdf = torch.as_tensor(plan.token_cdf, device=device)
    bank = (None if plan.cdf_bank is None
            else torch.as_tensor(plan.cdf_bank, device=device))
    perms = torch.as_tensor(plan.group_perms, dtype=torch.int64,
                            device=device)
    per = plan.global_batch // plan.n_groups
    gidx = torch.arange(plan.n_groups, device=device).repeat_interleave(per)

    def batch_of(q: int) -> dict:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(plan.data_keys[q]))
        cdf_q = cdf if bank is None else bank[int(plan.cdf_index[q])]
        out = {}
        for k, sp in sorted(specs.items()):
            u = torch.rand((plan.global_batch, sp.shape[1]), generator=gen,
                           device=device)
            ranks = torch.searchsorted(cdf_q, u).clamp_(0,
                                                        cdf_q.shape[0] - 1)
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
    device each round.  ``recorder`` traces the runs (module docstring)."""

    def __init__(self, trainer, plan: RunPlan, *,
                 batch_fn: Optional[Callable] = None, recorder=None):
        self.trainer = trainer
        self.plan = plan
        self.device = trainer.device
        self.recorder = recorder
        if batch_fn is None:
            self._batch_of = make_batch_fn(plan, trainer.cfg, self.device)
        else:
            self._batch_of = lambda q: {
                k: torch.as_tensor(np.array(v), device=self.device)
                for k, v in batch_fn(q).items()}
        self._step = trainer.train_step_fn()
        self._masks = torch.as_tensor(plan.masks, device=self.device)
        self._scales = torch.as_tensor(plan.delay_scales, device=self.device)
        self._gains = (None if plan.fault_gain is None else
                       torch.as_tensor(plan.fault_gain, device=self.device))

    def _round(self, state, q: int):
        """Round q: its batch, its mask, its scale (adaptive or sparsified
        plans only: a neutral plan leaves the trainer's static delay rule in
        charge) and its channels → (state, metric row on the device)."""
        plan, kw = self.plan, {}
        if plan.adaptive or plan.grad_density is not None:
            kw["delay_scale"] = self._scales[q]
        if plan.grad_density is not None:
            kw["grad_density"] = plan.grad_density[q]
        if self._gains is not None:
            kw["fault_gain"] = self._gains[q]
        state, m = self._step(state, self._batch_of(q), self._masks[q], **kw)
        return state, torch.stack([m[k].to(torch.float32) for k in METRICS])

    def _maybe_snapshot(self, snapshot, hi: int, state, stats) -> None:
        """Offer the end-of-chunk state when ``hi`` is a due boundary: the
        offer queues a device copy and its host fetch and returns, so the
        next chunk launches at once."""
        if snapshot is not None and snapshot.due(hi, self.plan.rounds):
            with _span(self.recorder, "snapshot_offer", "snapshot",
                       round=hi):
                snapshot.offer(hi, state)
            stats.snapshots += 1

    def _attach_obs(self, snapshot) -> None:
        """Give the snapshotter this run's recorder (its finalise spans come
        a cadence after the offer, inside the snapshotter)."""
        if self.recorder is not None and snapshot is not None and \
                getattr(snapshot, "recorder", None) is None:
            snapshot.recorder = self.recorder

    def _record(self, stats: ExecStats, rounds: int, all_ms: np.ndarray,
                lo: int) -> None:
        """The run's counters, and the guard channels of the metric rows
        (rounds ``lo``, ``lo + 1``, ...), now on the host."""
        rec = self.recorder
        if rec is None:
            return
        for i, row in enumerate(all_ms):
            if row[_SKIP_IDX] > 0:
                rec.instant("guard_skip", lane="faults", round=lo + i,
                            gscale=float(row[_GSCALE_IDX]))
            elif row[_GSCALE_IDX] != 1.0:
                rec.gauge("gscale", float(row[_GSCALE_IDX]), lane="faults")
        rec.count("rounds", rounds)
        rec.count("launches", stats.launches)
        rec.count("host_syncs", stats.host_syncs)
        rec.count("tap_events", stats.tap_events)
        rec.count("snapshots", stats.snapshots)

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
        rec = self.recorder
        self._attach_obs(snapshot)
        chunks = []
        for lo, hi in _chunk_bounds(self.plan.rounds, rounds_per_launch,
                                    start_round):
            rows = []
            with _span(rec, "launch", "executor", lo=lo, hi=hi):
                for q in range(lo, hi):
                    state, row = self._round(state, q)
                    rows.append(row)
            stats.launches += 1
            self._maybe_snapshot(snapshot, hi, state, stats)
            if metrics == "none":
                continue
            ms = torch.stack(rows)                   # (K, n_metrics), device
            if on_step is not None:
                with _span(rec, "host_sync", "executor", lo=lo, hi=hi):
                    ms = ms.cpu().numpy()            # blocking read per chunk
                stats.host_syncs += 1
                for i in range(lo, hi):
                    on_step(i, state, _row_dict(ms[i - lo]))
            chunks.append(ms)
        if snapshot is not None:
            snapshot.drain()
        rounds = self.plan.rounds - start_round
        if metrics == "none":
            with _span(rec, "barrier", "executor"):
                synchronize(self.device)             # completion barrier
            self._record(stats, rounds, np.zeros((0, len(METRICS))), 0)
            return ExecResult(state=state, metrics={}, stats=stats)
        if on_step is None and chunks:
            with _span(rec, "host_sync", "executor", deferred=True):
                chunks = [torch.cat(chunks).cpu().numpy()]  # one read
            stats.host_syncs = 1
        with _span(rec, "barrier", "executor"):
            synchronize(self.device)
        all_ms = np.concatenate(chunks, axis=0) if chunks else \
            np.zeros((0, len(METRICS)), np.float32)
        self._record(stats, rounds, all_ms, start_round)
        return ExecResult(state=state, metrics=_curves(all_ms), stats=stats)

    def run_eager(self, state, *, on_step: Optional[Callable] = None,
                  start_round: int = 0) -> ExecResult:
        """The parity oracle: one launch and one host read per round."""
        stats = ExecStats()
        rec = self.recorder
        rows = []
        for q in range(start_round, self.plan.rounds):
            with _span(rec, "launch", "executor", lo=q, hi=q + 1):
                state, row = self._round(state, q)
            stats.launches += 1
            with _span(rec, "host_sync", "executor", lo=q, hi=q + 1):
                row = row.cpu().numpy()              # host sync per round
            stats.host_syncs += 1
            rows.append(row)
            if on_step is not None:
                on_step(q, state, _row_dict(row))
        all_ms = np.stack(rows) if rows else \
            np.zeros((0, len(METRICS)), np.float32)
        self._record(stats, len(rows), all_ms, start_round)
        return ExecResult(state=state, metrics=_curves(all_ms), stats=stats)


def run_scan(trainer, plan: RunPlan, state, *, rounds_per_launch: int = 8,
             metrics: str = "chunk", on_step: Optional[Callable] = None,
             start_round: int = 0, batch_fn=None,
             snapshot=None, recorder=None) -> ExecResult:
    return PlanExecutor(trainer, plan, batch_fn=batch_fn,
                        recorder=recorder).run_scan(
        state, rounds_per_launch=rounds_per_launch, metrics=metrics,
        on_step=on_step, start_round=start_round, snapshot=snapshot)


def run_eager(trainer, plan: RunPlan, state, *,
              on_step: Optional[Callable] = None, start_round: int = 0,
              batch_fn=None, recorder=None) -> ExecResult:
    return PlanExecutor(trainer, plan, batch_fn=batch_fn,
                        recorder=recorder).run_eager(
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
