"""Request admission as an asynchronous-scheduler scenario.

The AsGrad observation — the ordering (i_t, π_t) never depends on gradient
*values* — has an exact serving analogue: with a fixed per-request token
budget (no content-dependent EOS), which queued request fills a freed slot
never depends on the *tokens* being decoded.  Admission is therefore a pure
host-side bookkeeping problem, and the existing scheduler registry
(``pure`` / ``random`` / ``shuffled`` / ``fedbuff`` …) already models it:
"worker i finishes and gets a new job" becomes "a slot frees and a queued
request is admitted".

:class:`AdmissionPolicy` wraps a real registry scheduler over
``n = n_requests`` logical workers.  Scheduler *proposals* (from
``initial_workers`` / ``next_workers``) are remapped to the nearest
still-queued, already-arrived request in cyclic request-id order — the same
remap idiom the scenario lane's elastic transform uses — so every policy
keeps its character:

* ``pure``      → ≈ FIFO (a completion proposes its own id; the cyclic
  remap lands on the next queued request),
* ``shuffled``  → permutation-ordered admission,
* ``random``    → ≈ uniform-random admission,
* ``fedbuff:b=…`` → freed slots buffer until ``b`` completions, then a
  batch of admissions lands together (flush guard drains the tail).

:class:`AdmissionTrace` records the realised admissions/completions and
lowers them to an ordinary :class:`repro_torch.core.engine.Schedule` — workers
are request ids, π_t is the completion count at admission time, finish
times are decode-step instants — so ``scenarios.tau_report`` prints serving
τ/concurrency statistics unchanged.

Inter-arrival times reuse the timing registry
(:class:`repro_torch.core.delays.TimingModel`): :func:`draw_arrivals` parses
``"pattern[:gap=G]"`` (pattern ∈ PATTERNS) and cumulates one draw per
request into integer arrival steps on the decode-step clock.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from ..core.delays import PATTERNS, TimingModel
from ..core.engine import Schedule
from ..core.schedulers import REGISTRY, make_scheduler


def parse_admission(spec: str) -> tuple[str, int]:
    """``"fedbuff:b=2"`` → ``("fedbuff", 2)``; bare names get b=1."""
    name, _, rest = spec.partition(":")
    if name not in REGISTRY:
        raise ValueError(
            f"unknown admission policy {name!r}; want one of {sorted(REGISTRY)}")
    b = 1
    for item in filter(None, rest.split(",")):
        k, _, v = item.partition("=")
        if k != "b":
            raise ValueError(f"unknown admission option {k!r} (only b=...)")
        b = int(v)
    return name, b


def draw_arrivals(n_requests: int, spec: Optional[str],
                  seed: int = 0) -> np.ndarray:
    """``"poisson:gap=4"`` → (n_requests,) int arrival steps (cumulated
    inter-arrival draws; the first request arrives at step 0).  ``None`` /
    ``""`` → everything arrives at step 0."""
    if not spec:
        return np.zeros(n_requests, dtype=np.int64)
    pattern, _, rest = spec.partition(":")
    if pattern not in PATTERNS:
        raise ValueError(
            f"unknown arrival pattern {pattern!r}; want one of {PATTERNS}")
    gap = 4.0
    for item in filter(None, rest.split(",")):
        k, _, v = item.partition("=")
        if k != "gap":
            raise ValueError(f"unknown arrival option {k!r} (only gap=...)")
        gap = float(v)
    tm = TimingModel(np.full(n_requests, gap), pattern, seed=seed)
    gaps = tm.sample_round(np.arange(n_requests))
    arrivals = np.floor(np.cumsum(gaps) - gaps[0]).astype(np.int64)
    return arrivals


class AdmissionPolicy:
    """Registry scheduler → "which queued request fills a freed slot".

    The wrapped scheduler runs over ``n_requests`` logical workers.  Its
    proposals queue up; :meth:`pick` consumes the next proposal and cyclic-
    remaps it onto the arrived-and-queued request set.  FedBuff-style
    ``wait_b`` policies emit no proposals until ``b`` completions have
    buffered — freed slots simply stay empty until the batch lands.
    """

    def __init__(self, name: str, n_requests: int, b: int = 1, seed: int = 0):
        self.name = name
        self.n = int(n_requests)
        self.sched = make_scheduler(name, self.n, b=min(b, self.n), seed=seed)
        self.wait_b = self.sched.wait_b
        self._proposals = deque(int(w) for w in self.sched.initial_workers())
        self._queued = set(range(self.n))     # not yet admitted
        self._finished_buf: list = []         # completions awaiting wait_b

    # -- events --------------------------------------------------------------
    def notify_completion(self, rid: int) -> None:
        """A request finished decoding; the scheduler may propose successors.

        Mirrors the engine's round boundary: ``next_workers`` fires once
        per ``wait_b`` buffered completions (a fedbuff scheduler samples
        its whole batch on each call — calling it per completion would
        over-produce proposals b-fold)."""
        self._finished_buf.append(int(rid))
        if len(self._finished_buf) >= self.wait_b:
            batch = self._finished_buf[:self.wait_b]
            self._finished_buf = self._finished_buf[self.wait_b:]
            self._proposals.extend(
                int(w) for w in self.sched.next_workers(batch))

    def cancel(self, rid: int) -> None:
        """Withdraw a queued request (deadline timeout / shed / drain):
        it can no longer be admitted — scheduler proposals that land on
        it cyclic-remap to the next queued request, exactly like an
        already-admitted id."""
        self._queued.discard(int(rid))

    def requeue(self, rid: int) -> None:
        """Re-admit a failed request into the queue (retry path): the
        request becomes pickable again AND a proposal for its own id is
        pushed, so a retry never starves behind a scheduler that has no
        completions left to propose from.  Deterministic — no RNG draw —
        so retried admission orders replay exactly."""
        rid = int(rid)
        self._queued.add(rid)
        self._proposals.append(rid)

    # -- selection -----------------------------------------------------------
    def _remap(self, proposal: int, avail: set) -> int:
        """Nearest available request at/after the proposal in cyclic id
        order (the scenario lane's elastic remap idiom)."""
        return min(avail, key=lambda q: ((q - proposal) % self.n, q))

    def pick(self, arrived: set, in_flight: int) -> Optional[int]:
        """Next request to admit, or None (nothing arrived+queued, or the
        policy is withholding proposals).  ``in_flight`` feeds the flush
        guard: once nothing is decoding and no proposals are buffered, a
        wait_b tail smaller than b would deadlock — drain it FIFO."""
        avail = arrived & self._queued
        if not avail:
            return None
        while self._proposals:
            p = self._proposals.popleft()
            q = self._remap(p, avail)
            self._queued.discard(q)
            return q
        if in_flight == 0:          # flush guard (fedbuff tail < b)
            q = min(avail)
            self._queued.discard(q)
            return q
        return None

    @property
    def n_queued(self) -> int:
        return len(self._queued)

    # -- durability ----------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serialisable snapshot of the policy (proposals, queue,
        wait_b buffer, scheduler RNG/permutation state) — enough that a
        crash-resumed serve picks the SAME admission order the
        uninterrupted run would have."""
        st = {"proposals": [int(p) for p in self._proposals],
              "queued": sorted(int(q) for q in self._queued),
              "finished_buf": [int(x) for x in self._finished_buf]}
        s = self.sched
        rng = getattr(s, "_rng", None)
        if rng is not None:
            st["rng"] = rng.bit_generator.state
        if hasattr(s, "_perm"):                    # shuffled variants
            st["perm"] = [int(x) for x in s._perm]
            st["perm_pos"] = int(s._r)
        return st

    def load_state(self, st: dict) -> None:
        self._proposals = deque(int(p) for p in st["proposals"])
        self._queued = {int(q) for q in st["queued"]}
        self._finished_buf = [int(x) for x in st["finished_buf"]]
        s = self.sched
        if "rng" in st and hasattr(s, "_rng"):
            s._rng.bit_generator.state = st["rng"]
        if "perm" in st:
            s._perm = np.asarray(st["perm"], dtype=np.int64)
            s._r = int(st["perm_pos"])


class AdmissionTrace:
    """Realised admission/completion events → an ordinary :class:`Schedule`.

    One Schedule row per *completed* request, in completion order (ties by
    slot id): ``workers[t]`` = request id, ``assign_iters[t]`` = number of
    completions at its admission instant (the server "iterate" the request
    was admitted at), ``finish_times[t]`` = completion decode-step,
    ``active_jobs[t]`` = requests in flight when it completed.  τ_C is then
    the realised serving concurrency (≤ n_slots), τ_max/τ_avg the
    queueing-induced staleness — the same statistics, the same report code.
    """

    def __init__(self, n_requests: int, wait_b: int = 1):
        self.n = int(n_requests)
        self.wait_b = int(wait_b)
        self._admit_step = {}       # rid -> decode step of admission
        self._admit_iter = {}       # rid -> completions at admission
        self._events = []           # (finish_step, slot, rid, in_flight)
        self._evictions = {}        # rid -> quarantine step (device)
        self._timeouts = {}         # rid -> deadline-timeout step (host)
        self._shed = {}             # rid -> overload-shed step (host)
        self._drained = {}          # rid -> drain-cancel step (host)
        self._attempts = {}         # rid -> failed attempts consumed
        self.completions = 0

    def admitted(self, rid: int, step: int) -> None:
        self._admit_step[rid] = int(step)
        self._admit_iter[rid] = self.completions

    def completed(self, rid: int, slot: int, step: int,
                  in_flight: int) -> None:
        self._events.append((int(step), int(slot), int(rid), int(in_flight)))
        self.completions += 1

    def evicted(self, rid: int, step: int) -> None:
        """The device quarantined ``rid``'s lane (non-finite logits) at
        decode step ``step``; its slot stays booked until the scheduled
        completion, so the Schedule row is unchanged — the eviction is
        extra degradation metadata."""
        self._evictions[rid] = int(step)

    def timed_out(self, rid: int, step: int) -> None:
        """``rid``'s queue wait blew its deadline at ``step``: it is never
        admitted and contributes no Schedule row."""
        self._timeouts[rid] = int(step)

    def shed(self, rid: int, step: int) -> None:
        """``rid`` was shed by overload control at ``step`` (bounded
        queue overflow): terminal, never admitted — no Schedule row."""
        self._shed[rid] = int(step)

    def drained(self, rid: int, step: int) -> None:
        """``rid`` was cancelled at ``step`` by a graceful drain (server
        stopped admitting): terminal — no Schedule row."""
        self._drained[rid] = int(step)

    def retried(self, rid: int, attempts: int) -> None:
        """``rid`` consumed one failed attempt (eviction/timeout);
        ``attempts`` is the running count — surfaces in the report's
        degraded section so retries are visible, not silent."""
        self._attempts[rid] = int(attempts)

    def schedule(self) -> Schedule:
        ev = sorted(self._events)
        return Schedule(
            workers=np.array([e[2] for e in ev], dtype=np.int32),
            assign_iters=np.array([self._admit_iter[e[2]] for e in ev],
                                  dtype=np.int32),
            finish_times=np.array([e[0] for e in ev], dtype=np.float64),
            active_jobs=np.array([e[3] for e in ev], dtype=np.int32),
            unfinished_assign_iters=np.array([], dtype=np.int32),
            wait_b=self.wait_b,
            n_workers=self.n,
        )

    @property
    def admit_steps(self) -> dict:
        return dict(self._admit_step)

    @property
    def evictions(self) -> dict:
        return dict(self._evictions)

    @property
    def timeouts(self) -> dict:
        return dict(self._timeouts)

    @property
    def shed_map(self) -> dict:
        return dict(self._shed)

    @property
    def drained_map(self) -> dict:
        return dict(self._drained)

    @property
    def attempts(self) -> dict:
        return dict(self._attempts)

    # -- durability ----------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serialisable trace state (dict keys stringify; load_state
        converts them back)."""
        return {
            "admit_step": {str(k): v for k, v in self._admit_step.items()},
            "admit_iter": {str(k): v for k, v in self._admit_iter.items()},
            "events": [list(e) for e in self._events],
            "evictions": {str(k): v for k, v in self._evictions.items()},
            "timeouts": {str(k): v for k, v in self._timeouts.items()},
            "shed": {str(k): v for k, v in self._shed.items()},
            "drained": {str(k): v for k, v in self._drained.items()},
            "attempts": {str(k): v for k, v in self._attempts.items()},
            "completions": self.completions,
        }

    def load_state(self, st: dict) -> None:
        as_int = lambda d: {int(k): int(v) for k, v in d.items()}  # noqa: E731
        self._admit_step = as_int(st["admit_step"])
        self._admit_iter = as_int(st["admit_iter"])
        self._events = [tuple(int(x) for x in e) for e in st["events"]]
        self._evictions = as_int(st["evictions"])
        self._timeouts = as_int(st["timeouts"])
        self._shed = as_int(st["shed"])
        self._drained = as_int(st["drained"])
        self._attempts = as_int(st["attempts"])
        self.completions = int(st["completions"])
