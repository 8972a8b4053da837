"""Whole-run executor: the plan's rounds on the device, two dispatch modes.

Counterpart of ``repro/runtime/executor.py``.  Both runtimes replay the
same :class:`RunPlan` through the same train step; masks and delay scales
live on the device for the whole run and batches are synthesised there from
the plan's tables, so no round ships data from the host.

* ``"scan"`` (:meth:`PlanExecutor.run_scan`) — ``rounds_per_launch`` (K)
  rounds are issued back to back as one launch.  PyTorch runs eagerly, so
  a "launch" here is a chunk of rounds the host enqueues without waiting;
  a CUDA graph over a round is a later slice.  How the metric rows reach
  the host is the ``metrics`` mode:

  - ``"chunk"`` stacks the rows on the device and reads the stack back at
    each chunk boundary when an ``on_step`` callback wants the values, and
    otherwise once for the whole run at its end;
  - ``"tap"`` streams each round's row to the host as the device reaches
    it, with no blocking read on the enqueue path: the row is copied
    (``non_blocking``) into a slot of a pinned host ring and an event is
    recorded behind the copy; the host delivers the rows whose events have
    completed, in round order, whenever it polls (after each round's
    enqueue and before each chunk's launch), and the rest at the end of
    the run.  ``on_step(i, None, row)`` fires per round (the mid-chunk
    state is not the callback's).  The ring holds one chunk of rows: a
    slot is written again only after its previous row, K rounds older,
    was delivered, so the host runs at most one chunk ahead of the device
    (K rounds stay queued on it; the waits are ``ExecStats.tap_waits``),
    which is what lets the divergence breaker stop the launches one chunk
    after the chunk that tripped it;
  - ``"none"`` discards the rows.
* ``"eager"`` (:meth:`PlanExecutor.run_eager`) — one round per launch and
  one host read of its metric row per round: the parity oracle.

:meth:`PlanExecutor.run_grid` is the γ-grid lane: a plan compiled with a
γ-axis (``compile_plan(..., grid_gammas=...)``) runs every grid point on
one trainer.  Each round's batch is synthesised once and shared by the
points; each point takes its own scale row through the explicit-scale
step.  The states are stacked with a leading ``(n_grid,)`` axis, and each
point steps on its contiguous slice (a pooled state's kernels run on the
point's slice of each pool).  The points run one after the other: one
batched launch over them is later work.

``launches`` and ``host_syncs`` count as in the JAX package: a launch per
chunk (scan, grid) or per round (eager); a host sync per blocking metric
read.  ``run_scan(snapshot=...)`` and ``run_grid(snapshot=...)`` offer the
end-of-chunk state (stacked, on the grid lane) to a
:class:`repro_torch.checkpoint.AsyncSnapshotter` at its due boundaries and
drain it at the end of the run; a restored state resumes through
``start_round``.  ``run_scan(breaker=...)`` (``"tap"`` only) feeds each
delivered row's loss to a :class:`repro_torch.faults.DivergenceBreaker`;
once it trips no further chunk is launched, the curves cover the launched
chunks, and ``ExecStats.tripped_round`` holds the trip.

A plan's scenario channels ride each round: the drifting data law picks
the round's row of the device-resident CDF bank (its index is a host
value, since the round loop is on the host), and the round passes its
keep-density (a host number) and its per-worker fault gains (a device
row) to the step.  A density forces the explicit-scale step, as in the
JAX executor.

Over data ranks (a trainer with a bound mesh) every rank runs the same
rounds on the same global batches (``make_batch_fn`` draws the whole
batch on each, from the same seed on the same device type; the trainer's
step keeps the rank's rows), and the metric rows are the all-reduced
values, equal on every rank.  Scan, eager, tap and the grid lane run so
(a grid point's slice of a ranked state holds the rank's rows); under
``"tap"`` only rank 0 hands rows to ``on_step``, and with a breaker every
rank drains its ring at each chunk boundary, so the ranks decide to stop
at the same boundary.  A snapshotter gets the trainer's state shardings
(:class:`~repro_torch.checkpoint.AsyncSnapshotter` gathers, rank 0
writes).

``recorder`` (a :class:`repro_torch.obs.Recorder`) traces the run at host
boundaries that exist anyway, and never adds a device sync: ``launch``
spans around the enqueue of each chunk (or eager round), ``host_sync``
spans around the metric reads, a ``barrier`` span around the completion
wait, ``snapshot_offer`` spans, the counters of :class:`ExecStats`, and,
from the metric rows once they are on the host, a ``guard_skip`` instant
per skipped round and a ``gscale`` gauge per round whose health scale is
not 1; under ``"tap"`` also a ``tap_round`` instant per delivered row and
a ``breaker_trip`` instant.  On the card a span measures host enqueue
time, not device time.  Without a recorder nothing is traced and nothing
is paid.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from contextlib import nullcontext
from typing import Callable, Optional

import numpy as np
import torch

from ..device import synchronize
from ..tree import tree_leaves, tree_map
from .plan import RunPlan

#: fixed metric order of the on-device metric row; mirrors the dict
#: returned by ``AsyncTrainer.train_step_fn``
METRICS = ("loss", "ce", "aux", "grad_norm", "participation",
           "skipped", "gscale")

#: metric transport modes of the scan executor
METRIC_MODES = ("chunk", "tap", "none")

_LOSS_IDX = METRICS.index("loss")
_SKIP_IDX = METRICS.index("skipped")
_GSCALE_IDX = METRICS.index("gscale")


def _span(rec, name, lane, **args):
    """A recorder span, or nothing without a recorder (an un-observed run
    pays nothing on the dispatch path)."""
    return rec.span(name, lane, **args) if rec is not None else nullcontext()


@dataclasses.dataclass
class ExecStats:
    """Dispatch accounting, one counter per mechanism:

    * ``launches`` — chunks on the scan runtime and the grid lane, rounds
      on the eager one;
    * ``host_syncs`` — times the host blocked on a metric read mid-run or
      at its end (none under ``"tap"`` and ``"none"``: the end-of-run wait
      for completion is a barrier, not a metric read);
    * ``tap_events`` — metric rows delivered by the tap (one per round
      under ``"tap"``);
    * ``tap_waits`` — times the tap ring had to wait for a row one chunk
      old before reusing its slot (the host had run that far ahead);
    * ``snapshots`` — offers to the snapshotter;
    * ``tripped_round`` — the round at which the divergence breaker
      tripped (None: no breaker, or it never tripped).
    """

    launches: int = 0
    host_syncs: int = 0
    tap_events: int = 0
    tap_waits: int = 0
    snapshots: int = 0
    tripped_round: Optional[int] = None


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
        """Metrics as one dict per round (a single run's curves only: a
        grid result keeps its ``(n_grid, rounds)`` arrays)."""
        if not self.metrics:
            return []
        first = next(iter(self.metrics.values()))
        if first.ndim != 1:
            raise ValueError(
                "rows is a single-run view; grid results carry "
                f"(n_grid, rounds) curves (got shape {first.shape})")
        return [{k: float(v[i]) for k, v in self.metrics.items()}
                for i in range(len(first))]


def make_batch_fn(plan: RunPlan, cfg, device) -> Callable:
    """``batch_of(q) -> batch dict``, drawn on ``device``.

    Tokens (the int32 specs of ``batch_specs``, whose length the audio
    family shortens to ``seq_len // dec_ratio``): inverse-CDF Zipf draws
    (``searchsorted`` on the plan's cumulative pmf) pushed through each
    group's vocab permutation, the law of the JAX package's device
    synthesis.  On a drifting plan round q draws from
    ``cdf_bank[cdf_index[q]]`` (the bank lives on the device, the index is
    read on the host).  The stubbed modality inputs (audio ``frames``, vlm
    ``patches``) are f32 standard normals of their spec's shape, as in the
    JAX package.  Every draw comes from one ``torch.Generator`` on
    ``device`` seeded with ``plan.data_keys[q]``, taken by the specs in
    key order: torch's stream, not JAX's."""
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
            if sp.dtype != "int32":            # stubbed modality inputs
                out[k] = torch.randn(sp.shape, generator=gen, device=device)
                continue
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
    return {k: all_ms[..., j] for j, k in enumerate(METRICS)}


class _TapRing:
    """The tap's transport: round i's device metric row is copied without
    blocking into slot ``i % depth`` of a pinned host ring, and an event is
    recorded behind the copy; :meth:`poll` hands the rows whose events have
    completed to ``emit(i, row)`` in round order.  A slot is reused only
    once its previous row has been handed over, waiting on its event if it
    must.  On the CPU the copy is done when it returns."""

    def __init__(self, device, depth: int, emit: Callable):
        self.cuda = device.type == "cuda"
        self.depth = depth
        self.emit = emit
        self.host = torch.empty((depth, len(METRICS)), dtype=torch.float32,
                                pin_memory=self.cuda)
        self.pending: deque = deque()      # (round, event or None)
        self.waits = 0

    def _ready(self, ev) -> bool:
        return ev is None or ev.query()

    def _hand_over(self, count_wait: bool = True) -> None:
        i, ev = self.pending.popleft()
        if not self._ready(ev):
            self.waits += count_wait
            ev.synchronize()
        self.emit(i, self.host[i % self.depth].numpy().copy())

    def put(self, i: int, row: torch.Tensor) -> None:
        if len(self.pending) == self.depth:      # slot i % depth is taken
            self._hand_over()
        self.host[i % self.depth].copy_(row, non_blocking=self.cuda)
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        self.pending.append((i, ev))
        self.poll()

    def poll(self) -> None:
        while self.pending and self._ready(self.pending[0][1]):
            self._hand_over()

    def drain(self) -> None:
        """Every pending row, waiting as needed (the end-of-run barrier,
        not counted in ``waits``)."""
        while self.pending:
            self._hand_over(count_wait=False)


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
        self._grid = (None if plan.grid_scales is None else
                      torch.as_tensor(plan.grid_scales, device=self.device))
        self._tap_sink = None         # the running tap's host consumer
        #: this process's rank among the trainer's data ranks (0 without)
        self.rank = getattr(trainer, "rank", 0)
        self.ranked = getattr(trainer, "mesh", None) is not None

    def _round(self, state, q: int, *, batch=None, scale=None):
        """Round q: its batch, its mask, its scale (adaptive or sparsified
        plans only: a neutral plan leaves the trainer's static delay rule in
        charge; the grid lane passes each point's ``scale``) and its
        channels → (state, metric row on the device)."""
        plan, kw = self.plan, {}
        if scale is not None:
            kw["delay_scale"] = scale
        elif plan.adaptive or plan.grad_density is not None:
            kw["delay_scale"] = self._scales[q]
        if plan.grad_density is not None:
            kw["grad_density"] = plan.grad_density[q]
        if self._gains is not None:
            kw["fault_gain"] = self._gains[q]
        if batch is None:
            batch = self._batch_of(q)
        state, m = self._step(state, batch, self._masks[q], **kw)
        return state, torch.stack([m[k].to(torch.float32) for k in METRICS])

    def _emit_tap(self, idx, row) -> None:
        """Host end of the tap: one delivered row to the running tap's
        consumer."""
        sink = self._tap_sink
        if sink is not None:
            sink(int(idx), np.asarray(row))

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
        a cadence after the offer, inside the snapshotter) and, over ranks,
        the state's shardings (its offers gather the state)."""
        if snapshot is None:
            return
        if self.recorder is not None and \
                getattr(snapshot, "recorder", None) is None:
            snapshot.recorder = self.recorder
        if self.ranked and snapshot.shardings is None:
            shardings = self.trainer.state_shardings()
            if self.plan.grid_scales is not None:     # the stacked states
                shardings = tree_map(lambda sh: sh.stacked(), shardings)
            snapshot.shardings = shardings

    def _record(self, stats: ExecStats, rounds: int, all_ms: np.ndarray,
                lo: int) -> None:
        """The run's counters, and the guard channels of the metric rows
        (rounds ``lo``, ``lo + 1``, ...), now on the host."""
        rec = self.recorder
        if rec is None:
            return
        for i, row in enumerate(all_ms):
            _guard_events(rec, lo + i, row)
        rec.count("rounds", rounds)
        rec.count("launches", stats.launches)
        rec.count("host_syncs", stats.host_syncs)
        rec.count("tap_events", stats.tap_events)
        rec.count("snapshots", stats.snapshots)

    def run_scan(self, state, *, rounds_per_launch: int = 8,
                 metrics: str = "chunk", on_step: Optional[Callable] = None,
                 start_round: int = 0, snapshot=None,
                 breaker=None) -> ExecResult:
        """Rounds ``[start_round, rounds)``, K = ``rounds_per_launch`` per
        launch.  ``on_step(i, state, metrics_i)`` fires for every round:
        at chunk boundaries with the end-of-chunk state under ``"chunk"``,
        per delivered row with ``state=None`` under ``"tap"``.
        ``snapshot`` (an :class:`~repro_torch.checkpoint.AsyncSnapshotter`)
        is offered the state at every due chunk boundary and drained at the
        end; the batches are a pure function of (seed, round), so a state
        restored from round r and run from ``start_round=r`` ends as the
        uninterrupted run does.  ``breaker`` (``"tap"`` only) stops the
        launches once it trips (module docstring)."""
        if metrics not in METRIC_MODES:
            raise ValueError(f"unknown metrics mode {metrics!r}; want one "
                             f"of {METRIC_MODES}")
        if metrics == "none" and on_step is not None:
            raise ValueError('metrics="none" discards metrics on device; an '
                             'on_step callback would never fire')
        if breaker is not None and metrics != "tap":
            raise ValueError(
                'the divergence breaker trips through the tap lane — run '
                'with metrics="tap" (chunk/none never stream per-round '
                'losses to the host mid-run)')
        if metrics == "tap":
            return self._run_tap(state, rounds_per_launch, on_step,
                                 start_round, snapshot, breaker)
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

    def _run_tap(self, state, rounds_per_launch, on_step, start_round,
                 snapshot, breaker) -> ExecResult:
        """``run_scan(metrics="tap")``: every round's row through the
        :class:`_TapRing`, no blocking metric read on the enqueue path."""
        stats = ExecStats()
        rec = self.recorder
        self._attach_obs(snapshot)
        tap_rows = {}

        def sink(i, row):
            tap_rows[i] = row
            stats.tap_events += 1
            if rec is not None:
                # a host boundary that exists anyway: one instant per row,
                # plus the guard channels when they fire
                rec.instant("tap_round", lane="tap", round=i)
                _guard_events(rec, i, row)
            if breaker is not None and not breaker.tripped:
                breaker.observe(i, row[_LOSS_IDX])
                if breaker.tripped and rec is not None:
                    rec.instant("breaker_trip", lane="faults",
                                round=breaker.tripped_round)
            if on_step is not None and self.rank == 0:
                on_step(i, None, _row_dict(row))

        k = max(int(rounds_per_launch), 1)
        ring = _TapRing(self.device, k, self._emit_tap)
        launched_hi = start_round
        self._tap_sink = sink
        try:
            for lo, hi in _chunk_bounds(self.plan.rounds, k, start_round):
                if breaker is not None and self.ranked:
                    ring.drain()     # every rank sees the same rows here
                ring.poll()
                if breaker is not None and breaker.tripped:
                    break                # stop launching; the queue drains
                with _span(rec, "launch", "executor", lo=lo, hi=hi):
                    for q in range(lo, hi):
                        state, row = self._round(state, q)
                        ring.put(q, row)
                stats.launches += 1
                launched_hi = hi
                self._maybe_snapshot(snapshot, hi, state, stats)
            with _span(rec, "barrier", "executor"):
                ring.drain()
                synchronize(self.device)         # completion barrier
        finally:
            self._tap_sink = None
        stats.tap_waits = ring.waits
        if snapshot is not None:
            snapshot.drain()
        if breaker is not None:
            stats.tripped_round = breaker.tripped_round
        n_rounds = launched_hi - start_round
        if len(tap_rows) != n_rounds:
            raise RuntimeError(
                f"metrics tap delivered {len(tap_rows)}/{n_rounds} rows — a "
                f"row was dropped or the run was interrupted mid-chunk")
        all_ms = (np.stack([tap_rows[i] for i in
                            range(start_round, launched_hi)])
                  if n_rounds else np.zeros((0, len(METRICS)), np.float32))
        self._record(stats, n_rounds, np.zeros((0, len(METRICS))), 0)
        return ExecResult(state=state, metrics=_curves(all_ms), stats=stats)

    # ------------------------------------------------------------------ grid
    def stack_state(self, state):
        """One state tiled with a leading ``(n_grid,)`` axis (new
        tensors): every grid point starts from the same iterate."""
        g = self.plan.n_grid
        return tree_map(lambda x: x.unsqueeze(0).expand(
            (g,) + tuple(x.shape)).clone(), state)

    def run_grid(self, state, *, rounds_per_launch: int = 8,
                 metrics: str = "chunk", start_round: int = 0,
                 snapshot=None) -> ExecResult:
        """Every grid point of a γ-axis plan on this executor's trainer.

        ``state`` is one trainer state (tiled by :meth:`stack_state`) or an
        already stacked ``(n_grid, ...)`` tree (a resumed grid run).  Round
        q's batch is drawn once; point i steps its slice of the stacked
        state with the scale ``grid_scales[i, q]``, and what the step
        returns as new tensors (the step counter, the reference route's
        leaves) is copied back into the slice.  Metrics come back as
        ``(n_grid, rounds)`` curves under ``"chunk"`` (one deferred read;
        there is no per-point ``on_step``) or not at all under ``"none"``;
        ``"tap"`` is refused, as in the JAX package.  ``snapshot`` is
        offered the stacked state at due chunk boundaries; a restored grid
        snapshot is the already stacked state of a resumed run."""
        plan = self.plan
        if plan.grid_scales is None:
            raise ValueError(
                "plan has no γ-axis; compile it with grid_gammas=... to "
                "use the grid lane")
        if metrics not in ("chunk", "none"):
            raise ValueError(
                f'grid lane supports metrics="chunk"|"none" (got '
                f'{metrics!r})')
        g = plan.n_grid
        stacked = state["step"].dim() == 1
        states = state if stacked else self.stack_state(state)
        state = None
        points = [tree_map(lambda x, i=i: x[i], states) for i in range(g)]
        stats = ExecStats()
        rec = self.recorder
        self._attach_obs(snapshot)
        chunks = []
        last_hi = start_round
        for lo, hi in _chunk_bounds(plan.rounds, rounds_per_launch,
                                    start_round):
            rows = []
            with _span(rec, "launch", "executor", lo=lo, hi=hi, grid=g):
                for q in range(lo, hi):
                    batch = self._batch_of(q)
                    row = []
                    for i, view in enumerate(points):
                        new, m = self._round(view, q, batch=batch,
                                             scale=self._grid[i, q])
                        _write_back(view, new)
                        row.append(m)
                    rows.append(torch.stack(row))        # (n_grid, n_m)
            stats.launches += 1
            last_hi = hi
            self._maybe_snapshot(snapshot, hi, states, stats)
            if metrics == "chunk":
                chunks.append(torch.stack(rows, dim=1))  # (n_grid, K, n_m)
        if chunks:
            with _span(rec, "host_sync", "executor", deferred=True):
                all_ms = torch.cat(chunks, dim=1).cpu().numpy()  # one read
            stats.host_syncs = 1
        with _span(rec, "barrier", "executor"):
            synchronize(self.device)
        if snapshot is not None:
            snapshot.drain()
        self._record(stats, last_hi - start_round,
                     np.zeros((0, len(METRICS))), 0)
        return ExecResult(state=states,
                          metrics=_curves(all_ms) if chunks else {},
                          stats=stats)

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


def _guard_events(rec, i: int, row) -> None:
    """Round i's guard channels from its host metric row: a ``guard_skip``
    instant when it was skipped, else a ``gscale`` gauge when its health
    scale is not 1."""
    if row[_SKIP_IDX] > 0:
        rec.instant("guard_skip", lane="faults", round=i,
                    gscale=float(row[_GSCALE_IDX]))
    elif row[_GSCALE_IDX] != 1.0:
        rec.gauge("gscale", float(row[_GSCALE_IDX]), lane="faults")


def _write_back(view, new) -> None:
    """Copy each leaf of ``new`` that is not already ``view``'s own storage
    into it (the in-place routes return their operands; the step counter,
    the health vector and the reference route's leaves are new tensors)."""
    for dst, src in zip(tree_leaves(view), tree_leaves(new)):
        if src.data_ptr() != dst.data_ptr():
            dst.copy_(src)


def run_scan(trainer, plan: RunPlan, state, *, rounds_per_launch: int = 8,
             metrics: str = "chunk", on_step: Optional[Callable] = None,
             start_round: int = 0, batch_fn=None,
             snapshot=None, breaker=None, recorder=None) -> ExecResult:
    return PlanExecutor(trainer, plan, batch_fn=batch_fn,
                        recorder=recorder).run_scan(
        state, rounds_per_launch=rounds_per_launch, metrics=metrics,
        on_step=on_step, start_round=start_round, snapshot=snapshot,
        breaker=breaker)


def run_grid(trainer, plan: RunPlan, state, *, rounds_per_launch: int = 8,
             metrics: str = "chunk", start_round: int = 0, batch_fn=None,
             snapshot=None, recorder=None) -> ExecResult:
    return PlanExecutor(trainer, plan, batch_fn=batch_fn,
                        recorder=recorder).run_grid(
        state, rounds_per_launch=rounds_per_launch, metrics=metrics,
        start_round=start_round, snapshot=snapshot)


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
