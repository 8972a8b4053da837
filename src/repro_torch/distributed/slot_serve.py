"""Slot-based continuous-batching serving: one captured ragged decode chunk.

Counterpart of ``repro/distributed/slot_serve.py``, on one device or over a
mesh (below).  ``n_slots`` persistent decode lanes, each with its own
position, activity and budget, are stepped by ONE program:

* **Device.**  The decode state (the ragged cache of
  ``models.init_cache(..., ragged=True)``, and per slot the last token,
  position, activity, remaining budget, request id, sampling counter and
  attempt) is a set of tensors allocated once per server and updated in
  place.  A chunk of ``steps_per_launch`` (K) ragged ``models.decode_step``
  calls runs over it: inactive slots freeze (token, position and budget
  held by the activity mask) and their ring re-writes are idempotent, so
  masking replaces control flow.  On CUDA the chunk is captured once as a
  ``torch.cuda.CUDAGraph`` (the counterpart of JAX's one ``jit`` of a
  ``lax.scan``) and replayed for every chunk of every serve; the graph
  reads the server's own copy of the params, refreshed at each serve.
  ``capture=False`` runs the same steps eagerly: the CPU route, and the
  card's yardstick for graph ≡ eager.
* **Tap.**  Each step writes its (tokens, active, quarantined) row into a
  (K, 3, n_slots) device buffer.  After each chunk a non-blocking copy
  into pinned host memory is queued with an event; on a clean serve the
  host folds chunk c's rows into the ledger after it has queued chunk
  c + 1, so the device keeps one chunk of run-ahead.  The host counts how
  often it had to wait for a row (``ServeResult.host_waits``).  This is
  the port's form of the JAX package's ordered ``io_callback``.
* **Host.**  With a fixed per-request token budget there is no
  content-dependent exit: admissions, completions, occupancy and TTFT are
  bookkeeping, and no device value steers the loop.  Admission (which
  queued request fills a freed slot, at chunk boundaries) is a registry
  scheduler via :class:`~repro_torch.distributed.admission.AdmissionPolicy`,
  and the realised trace lowers to an ordinary ``Schedule``.
* **Prefill** per admitted request: an eager batch-1 prefill at the prompt
  length (the path's kernel work: the flash kernel on the dense and moe
  families, the SSD kernel on the ssm family, both on the hybrid) gives
  the first token and a cache row, which in-place index copies write into
  the request's slot.  On the moe family the rows of a decode step share
  one capacity-bounded dispatch, so a request's tokens depend on its
  neighbours, empty slots included, as in the JAX package.
* **Sampling** (``temperature > 0``) is Gumbel-max over a counter-based
  integer hash of (seed, request id, attempt, decode step within the
  attempt, vocabulary index), computed with torch ops inside the chunk;
  the attempt is folded in only from the first retry on.  A request's
  stream is a pure function of those, whatever its slot or the pool width.
  The streams are the port's own: JAX's threefry keys cannot be
  reproduced, and one ``torch.Generator`` cannot give per-slot streams
  inside one graph.
* **Degradation is masked, not crashed**: an active lane whose logits go
  non-finite is quarantined on the device (budget zeroed, no token) and
  the host learns of it from the tap; queued requests whose wait exceeds
  a ``deadline`` time out at admission sweeps.
* **Resilience**, as in the JAX package: a :class:`RetryPolicy` re-queues
  evicted and timed-out requests after a deterministic backoff and
  re-prefills ``prompt + tokens emitted so far``; an
  :class:`OverloadPolicy` bounds the admission queue and sheds;
  ``drain_after`` stops admitting and finishes the lanes in flight; serve
  faults poison (request, step) cells through the chunk's (K, n_slots)
  mask (an all-false mask is identity, bit for bit) and schedule
  :class:`ServePreempted` at chunk boundaries; an
  :class:`~repro_torch.checkpoint.AsyncSnapshotter` is offered the decode
  state plus the host ledger at due boundaries, and ``resume_from``
  restores both and continues.  Any of retry, faults, a snapshotter or a
  resume folds each chunk's tap rows before the next sweep, so the ledger
  is whole at every sweep; a clean serve keeps the run-ahead.

**Over a mesh** (``mesh``: a bound ``launch.mesh.ProcessMesh``, with the
JAX ``SlotServer``'s ``rules``) every rank runs the same driver:

* **Lanes.**  Each data rank holds a contiguous block of ``n_slots / D``
  slots (the data axes flattened, as JAX's lanes lie on the last data
  axis of a (data, model) mesh), its rows of every per-slot tensor and its
  block of the ragged cache under the rules; over the model axis each
  rank decodes on its blocks of the params and the cache
  (``models/tp.py``), the logits whole on every model rank.
* **One ledger.**  Every rank folds the same tap: after each chunk the
  rank's tap rows ``(K, 3, n_slots / D)`` are all-gathered over the data
  group into ``(K, 3, n_slots)``.  Admission, retry, shedding, drain and
  TTFT are pure functions of that tap and of the seeded policies, so no
  rank broadcasts a decision and the ``ServeResult`` is the same on every
  rank.  The first tokens of a sweep's admissions are summed over the
  data group (the owner's token, zeros elsewhere) in one all-reduce.
* **Prefill** runs on the data rank that owns the admitted slot only: a
  batch-1 prefill on its model group (``tp=``), outside the data context,
  so the MoE dispatches the prompt as one group, as JAX's plain ``jit`` of
  the replicated prompt does.
* **The chunk runs eagerly**: each decode step holds the model group's
  collectives (and, on the MoE, the data group's), which this slice does
  not capture in a CUDA graph.  Without a mesh nothing changes.
* **Resilience**: poison cells land in the owner's rows of the mask,
  :class:`ServePreempted` is raised on every rank at the same boundary, a
  snapshotter gathers the lanes' blocks (rank 0 writes them with the
  ledger; the ranked checkpoint format) and ``resume_from`` gives each
  rank its blocks back; a snapshot of another mesh is refused.

The serve snapshot is the port's own structure (the cache leaves and the
per-slot tensors; JAX's holds PRNG keys), so serve snapshots do not cross
packages; their ``meta.json`` ledger, ``admission_policy`` and
``admission_trace`` have the JAX package's schema.

A ``recorder`` (:class:`repro_torch.obs.Recorder`) traces a serve at its
host boundaries, with the JAX server's event names: ``admission_sweep``,
``prefill`` and ``admit`` spans on the ``server`` lane, one ``request``
span per request's lifetime on its ``slot{i}`` lane, ``launch`` spans
around each chunk's replay, ``evict`` / ``retry`` / ``timeout`` /
``shed`` / ``drain_start`` instants, ``in_flight`` and ``occupancy``
gauges per sweep, a ``ttft_steps`` histogram and the serve's counters.
Spans time the host: on the card a ``launch`` span is the replay's
enqueue.  The server's :class:`~repro_torch.obs.CompileWatch` counts the
chunk's captures (``compile_counts``).
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models import model as M
from ..obs import CompileWatch
from ..tree import tree_leaves, tree_map
from .admission import AdmissionPolicy, AdmissionTrace, parse_admission
from .collectives import all_gather, all_reduce
from .sharding import (DEFAULT_RULES, NamedSharding, PSpec,
                       check_model_axis, pool_axes, sharded_trace,
                       tree_shardings)


def _span(rec, name, lane, **args):
    """A recorder span, or nothing without a recorder (an un-observed serve
    pays nothing)."""
    return rec.span(name, lane, **args) if rec is not None else nullcontext()


@dataclasses.dataclass
class SlotConfig:
    """Knobs of the slot loop.

    ``steps_per_launch`` is the decode analogue of the executor's
    ``rounds_per_launch``: admissions land at chunk boundaries, so it
    trades admission latency against launch amortisation.
    """

    n_slots: int
    ctx_len: int
    temperature: float = 0.0     # 0 = greedy
    seed: int = 0
    steps_per_launch: int = 8

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if self.steps_per_launch < 1:
            raise ValueError("steps_per_launch must be >= 1")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded re-admission of degraded requests.

    A quarantine eviction or deadline timeout consumes one *attempt*;
    while ``attempts consumed < max_attempts`` the request re-enters the
    admission queue after ``backoff_steps(failures)`` decode steps
    (``backoff_base · backoff_factor^(failures−1)``), replaying its
    already-emitted token prefix through prefill.  At the cap the last
    failure is terminal and lands in ``ServeResult.evictions`` /
    ``.timeouts`` with the attempt count in ``.attempts``.
    ``max_attempts=1`` is the no-retry semantics exactly.
    """

    max_attempts: int = 2
    backoff_base: int = 4
    backoff_factor: float = 2.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1 (got {self.max_attempts})")
        if self.backoff_base < 0:
            raise ValueError(
                f"backoff_base must be >= 0 (got {self.backoff_base})")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1 (got {self.backoff_factor})")

    def backoff_steps(self, failures: int) -> int:
        """Decode steps to wait after the ``failures``-th failure."""
        return int(round(self.backoff_base
                         * self.backoff_factor ** (max(failures, 1) - 1)))


SHED_POLICIES = ("reject-new", "drop-oldest")


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Bounded admission queue: at every sweep, eligible-but-waiting
    requests beyond ``queue_cap`` are shed (terminal, accounted in
    ``ServeResult.shed``) — ``reject-new`` drops the newest entrants,
    ``drop-oldest`` drops the head of the queue to make room for them.
    """

    queue_cap: int
    shed: str = "reject-new"

    def __post_init__(self):
        if self.queue_cap < 1:
            raise ValueError(
                f"queue_cap must be >= 1 (got {self.queue_cap})")
        if self.shed not in SHED_POLICIES:
            raise ValueError(
                f"unknown shed policy {self.shed!r}; want one of "
                f"{SHED_POLICIES}")


class ServePreempted(RuntimeError):
    """Raised by ``serve`` at a scheduled ``serve_preempt`` boundary
    (after forcing a snapshot offer and draining it, when a snapshotter is
    attached).  Carries the decode step the driver stopped at; callers
    catch it and resume through ``serve(resume_from=...)``."""

    def __init__(self, step: int, at: int):
        super().__init__(
            f"serve driver preempted at decode-step boundary {step} "
            f"(scheduled at step {at})")
        self.step = int(step)
        self.at = int(at)


@dataclasses.dataclass
class ServeResult:
    """Per-request token matrix + the realised admission world.

    Degraded requests pad: an evicted request's ``tokens`` row holds −1
    from its (last attempt's) quarantine point on, keeping any prefix
    earlier attempts recovered; a timed-out, shed or drained request that
    was never admitted has an all −1 row and a −1 ``ttft_steps`` entry.
    Every request lands in exactly one of: a full token row,
    ``evictions``, ``timeouts``, ``shed`` or ``drained``.
    """

    tokens: np.ndarray           # (n_requests, max_new) int32, −1 padded
    schedule: object             # repro_torch.core.engine.Schedule
    ttft_steps: np.ndarray       # (n_requests,) admission − arrival (steps)
    occupancy: float             # mean fraction of busy slot-steps
    decode_steps: int            # launched decode steps (across resumes)
    chunks: int                  # chunk launches (across resumes)
    tap_rows: int                # tap rows this serve folded
    evictions: dict = dataclasses.field(default_factory=dict)
    #: rid -> decode step its lane was quarantined; with retries, only the
    #: terminal (attempt-exhausted) evictions
    timeouts: dict = dataclasses.field(default_factory=dict)
    #: rid -> decode step its queue wait exceeded the deadline (terminal)
    shed: dict = dataclasses.field(default_factory=dict)
    #: rid -> decode step overload control shed it (terminal)
    drained: dict = dataclasses.field(default_factory=dict)
    #: rid -> decode step a graceful drain cancelled it (terminal)
    attempts: dict = dataclasses.field(default_factory=dict)
    #: rid -> failed attempts consumed (retried requests only)
    resumed_from: Optional[int] = None
    #: decode step this serve resumed a snapshot at (None = fresh run)
    host_waits: int = 0
    #: times the host found a chunk's tap rows not yet on the host and
    #: waited for them (0 when the device never fell behind the host)
    chunk_device_ms: Optional[float] = None
    #: device time of this serve's chunks, CUDA events around each launch
    #: (ms; None off CUDA)


def _tok_int(x) -> int:
    """Host int from a deferred device first token (or an int)."""
    return x if isinstance(x, int) else int(x.reshape(-1)[0])


class _Ledger:
    """Host-side bookkeeping of one serve run.

    Everything the sweep loop needs to steer admission, retries, shedding
    and accounting lives here, and it is JSON-serialisable
    (:meth:`to_json` / :meth:`from_json`, the JAX package's schema), so a
    snapshot restores the driver's world, not just the device state.
    Request lifecycle: ``queued`` (waiting or backing off,
    ``eligible[rid]`` = step it may be admitted from) → ``inflight``
    (occupies a slot, ``fin[rid]`` = completion step of this attempt) →
    ``done`` (completed or terminally failed).
    """

    def __init__(self, n_req: int, n_slots: int, arrivals):
        self.t = 0                   # decode-step clock (chunk boundaries)
        self.chunks = 0              # lifetime chunk count (across resumes)
        self.busy_steps = 0
        self.slot_rid = [-1] * n_slots
        self.state_of = {r: "queued" for r in range(n_req)}
        self.eligible = {r: int(arrivals[r]) for r in range(n_req)}
        self.fin = {}          # rid -> completion step of this attempt
        self.admit_t = {}      # rid -> first admission step (ttft)
        self.tries = {}        # rid -> failed attempts consumed
        self.emitted = {}      # rid -> ints recovered by failed attempts
        self.outputs = {}      # rid -> [tok0 (device|int), ints...]
        self.cur_evict = {}    # rid -> quarantine step (tap-written)
        self.evict_events = []  # [rid, step] in tap order
        self.evt_cursor = 0    # events before it are host-processed
        self.evictions = {}    # terminal accounting maps (rid -> step)
        self.timeouts = {}
        self.shed = {}
        self.drained = {}
        self.drain_t = None    # step the drain began (None = not draining)

    @property
    def in_flight(self) -> int:
        return sum(1 for v in self.state_of.values() if v == "inflight")

    @property
    def done(self) -> int:
        return sum(1 for v in self.state_of.values() if v == "done")

    _INT_MAPS = ("eligible", "fin", "admit_t", "tries", "cur_evict",
                 "evictions", "timeouts", "shed", "drained")

    def to_json(self) -> dict:
        out_rows = {}
        for rid, row in self.outputs.items():
            row[0] = _tok_int(row[0])         # the deferred read, once
            out_rows[str(rid)] = [int(x) for x in row]
        d = {"t": self.t, "chunks": self.chunks,
             "busy_steps": self.busy_steps,
             "slot_rid": [int(s) for s in self.slot_rid],
             "state_of": {str(k): v for k, v in self.state_of.items()},
             "emitted": {str(k): [int(x) for x in v]
                         for k, v in self.emitted.items()},
             "outputs": out_rows,
             "evict_events": [[int(a), int(b)] for a, b in
                              self.evict_events],
             "evt_cursor": int(self.evt_cursor),
             "drain_t": self.drain_t}
        for name in self._INT_MAPS:
            d[name] = {str(k): int(v)
                       for k, v in getattr(self, name).items()}
        return d

    @classmethod
    def from_json(cls, d: dict) -> "_Ledger":
        L = cls(0, len(d["slot_rid"]), [])
        L.t = int(d["t"])
        L.chunks = int(d["chunks"])
        L.busy_steps = int(d["busy_steps"])
        L.slot_rid = [int(s) for s in d["slot_rid"]]
        L.state_of = {int(k): str(v) for k, v in d["state_of"].items()}
        L.emitted = {int(k): [int(x) for x in v]
                     for k, v in d["emitted"].items()}
        L.outputs = {int(k): [int(x) for x in v]
                     for k, v in d["outputs"].items()}
        L.evict_events = [[int(a), int(b)] for a, b in d["evict_events"]]
        L.evt_cursor = int(d["evt_cursor"])
        L.drain_t = None if d["drain_t"] is None else int(d["drain_t"])
        for name in cls._INT_MAPS:
            setattr(L, name, {int(k): int(v) for k, v in d[name].items()})
        return L


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer mixer (xorshift-multiply rounds) on int64 tensors
    or ints holding values in [0, 2³²); the multipliers are below 2³¹, so
    no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


class _Lanes:
    """The decode state of ``n_slots`` lanes as tensors allocated once, and
    one ragged decode step over them, written in place.  On a mesh: this
    rank's rows (``n`` of them, from slot ``lo`` on) and its block of the
    ragged cache (``cache_shardings``), decoded under the mesh's
    context."""

    def __init__(self, cfg: ArchConfig, slots: SlotConfig, device,
                 mesh=None, rules=None, cache_shardings=None):
        S, K = slots.n_slots, slots.steps_per_launch
        self.cfg, self.slots = cfg, slots
        self.decode = M.decode_step
        self.n, self.lo = S, 0
        if mesh is not None:
            data = pool_axes(mesh, rules)
            self.n = S // mesh.count(data)
            self.lo = mesh.my_index(data) * self.n
            self.decode = sharded_trace(M.decode_step, mesh, rules)
        S = self.n
        self.cache = M.init_cache(cfg, slots.n_slots, slots.ctx_len, device,
                                  ragged=True, shardings=cache_shardings)
        i64 = dict(dtype=torch.int64, device=device)
        self.toks = torch.zeros(S, **i64)
        self.pos = torch.zeros(S, dtype=torch.int32, device=device)
        self.active = torch.zeros(S, dtype=torch.bool, device=device)
        self.remaining = torch.zeros(S, **i64)
        self.rid = torch.zeros(S, **i64)             # sampling stream id
        self.ctr = torch.zeros(S, **i64)             # decode step in attempt
        self.attempt = torch.zeros(S, **i64)         # failed attempts before
        #: (K, S) fault mask: all false but in a chunk with a poisoned cell
        self.poison = torch.zeros((K, S), dtype=torch.bool, device=device)
        #: (K, 3, S) tap rows: tokens, active, quarantined
        self.tap = torch.zeros((K, 3, S), **i64)
        self.vocab_idx = torch.arange(cfg.vocab, **i64)
        self.seed_h = _mix32(int(slots.seed) & _M32)

    def state(self) -> dict:
        """The decode state a snapshot holds (the tap and the poison mask
        are zero or consumed at every chunk boundary)."""
        return {"cache": self.cache, "toks": self.toks, "pos": self.pos,
                "active": self.active, "remaining": self.remaining,
                "rid": self.rid, "ctr": self.ctr, "attempt": self.attempt}

    def reset(self) -> None:
        """Every slot empty: inactive lanes decode and discard until a
        request is admitted."""
        for leaf in tree_leaves(self.cache):
            leaf.zero_()
        if "positions" in self.cache:
            self.cache["positions"].fill_(-1)
        for t in (self.toks, self.pos, self.active, self.remaining,
                  self.rid, self.ctr, self.attempt, self.poison, self.tap):
            t.zero_()

    def admit(self, slot: int, pcache: dict, tok0, pos0: int, rem0: int,
              rid: int, attempt: int = 0) -> None:
        """Write a batch-1 prefill's cache row and first token into
        ``slot``, in place; the sampling stream restarts at step 0 of
        (rid, attempt)."""
        def write(c, p):
            if c.dim() == p.dim() + 1:            # the (S, W) positions row
                c[slot].copy_(p)
            else:                                 # (layers, S, ...) ← row 0
                c[:, slot].copy_(p[:, 0])

        tree_map(write, self.cache, pcache)
        self.toks[slot:slot + 1].copy_(tok0)
        self.pos[slot] = pos0
        self.active[slot] = rem0 > 0
        self.remaining[slot] = rem0
        self.rid[slot] = rid
        self.ctr[slot] = 0
        self.attempt[slot] = attempt

    def _sample(self, logits):
        """Gumbel-max over the (seed, rid, attempt, step, vocab index)
        hash; attempt 0 hashes as (seed, rid, step, vocab index)."""
        h = _mix32(self.seed_h ^ self.rid)                           # (S,)
        h = torch.where(self.attempt > 0, _mix32(h ^ self.attempt), h)
        h = _mix32(h ^ self.ctr)
        bits = _mix32(h[:, None] ^ self.vocab_idx[None, :])          # (S, V)
        u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.float() / self.slots.temperature + gumbel,
                            dim=-1)

    def step(self, params, j: int) -> None:
        """Decode step ``j`` of a chunk: every lane decodes, active lanes
        with finite logits emit, non-finite ones (a poisoned cell's logits
        are NaN) are quarantined."""
        logits, _ = self.decode(self.cfg, params, self.cache, self.toks,
                                self.pos, self.slots.ctx_len)
        logits = logits.masked_fill(self.poison[j][:, None], float("nan"))
        act = self.active
        finite = torch.isfinite(logits).all(dim=-1)
        quar = act & ~finite
        act = act & finite
        if self.slots.temperature > 0:
            nxt = self._sample(logits)
        else:
            nxt = torch.argmax(logits, dim=-1)        # first maximal index
        step = act.to(torch.int64)
        toks = torch.where(act, nxt, self.toks)
        rem = (self.remaining - step) * (~quar).to(torch.int64)
        self.tap[j, 0].copy_(toks)
        self.tap[j, 1].copy_(act)
        self.tap[j, 2].copy_(quar)
        self.toks.copy_(toks)
        self.pos.add_(step.to(torch.int32))
        self.active.copy_(act & (rem > 0))
        self.remaining.copy_(rem)
        self.ctr.add_(1)


class SlotServer:
    """Continuous-batching decode over ``n_slots`` ragged lanes on
    ``device`` (default CUDA).  ``capture=False`` runs the chunk eagerly on
    the card too.  ``recorder`` traces every serve (module docstring).

    ``mesh`` (a bound ``launch.mesh.ProcessMesh``) and ``rules`` serve
    over the mesh, as the port's ``Server`` takes them: every rank builds
    the server and calls ``serve`` with the same arguments, its params
    the rank's blocks (``init_params(..., shardings=
    server.param_shardings())``).  ``n_slots`` must divide over the data
    axes (``ValueError`` otherwise, before any collective), and the chunk
    runs eagerly there (module docstring)."""

    def __init__(self, cfg: ArchConfig, slots: SlotConfig, device="cuda",
                 capture: bool = True, recorder=None, *, mesh=None,
                 rules=None):
        if cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"slot serving admits token-only prompts; the {cfg.family!r} "
                "family needs per-request modality inputs (follow-up)")
        self.cfg, self.slots = cfg, slots
        self.device = resolve_device(device)
        self.mesh, self.rules = mesh, rules or DEFAULT_RULES
        self._tp = None               # the admission prefill's model group
        self._data = None             # the data group (None: one data rank)
        if mesh is not None:
            check_model_axis(cfg, mesh, self.rules)
            data = pool_axes(mesh, self.rules)
            if slots.n_slots % mesh.count(data):
                raise ValueError(
                    f"n_slots = {slots.n_slots} does not divide over the "
                    f"{mesh.count(data)} data ranks of mesh {mesh.shape}")
            if mesh.count(data) > 1:
                self._data = mesh.group(data)
            model = (self.rules.model_axis,)
            if mesh.count(model) > 1:
                from ..models.tp import TP

                self._tp = TP(cfg, mesh.group(model), mesh.count(model),
                              mesh.my_index(model), self.rules)
        # on a mesh every decode step holds collectives: the eager chunk
        self.capture = (capture and self.device.type == "cuda"
                        and mesh is None)
        self.recorder = recorder      # repro_torch.obs.Recorder | None
        self.watch = CompileWatch(recorder)   # counts the chunk's captures
        self.watch.register("chunk")
        self._lanes = _Lanes(cfg, slots, self.device, mesh, self.rules,
                             self.cache_shardings())
        self._graph = None            # the captured chunk
        self._params = None           # the graph's copy of the params
        self._prefill_fns = {}        # prompt_len -> batch-1 prefill
        self._tap_host = None         # two host buffers for the tap rows

    def compile_counts(self) -> dict:
        """How often each program was built: ``chunk``, the captures of the
        chunk's CUDA graph (0 on the eager route), from the server's
        :class:`~repro_torch.obs.CompileWatch`.  Rotating requests through
        freed slots and serving again keep it at 1.  Admission and prefill
        run eagerly, so nothing of theirs is built."""
        return self.watch.counts()

    # ---- shardings (a mesh) ------------------------------------------------
    def param_shardings(self):
        """The params' layout (None without a mesh): a rank holds
        ``NamedSharding.local`` of each whole leaf."""
        if self.mesh is None:
            return None
        return tree_shardings(M.param_specs(self.cfg), self.mesh, self.rules)

    def cache_shardings(self):
        """The ragged cache's layout (None without a mesh): the rules on
        ``cache_specs(..., ragged=True)``."""
        if self.mesh is None:
            return None
        return tree_shardings(M.cache_specs(
            self.cfg, self.slots.n_slots, self.slots.ctx_len, ragged=True),
            self.mesh, self.rules)

    def state_shardings(self):
        """The layout of the decode state a snapshot holds (None without a
        mesh): the cache's, and every per-slot tensor's rows over the data
        axes."""
        if self.mesh is None:
            return None
        data = pool_axes(self.mesh, self.rules)
        lane = NamedSharding(self.mesh, PSpec(
            (data if len(data) > 1 else data[0]) if data else None))
        out = {k: lane for k in self._lanes.state() if k != "cache"}
        out["cache"] = self.cache_shardings()
        return out

    # ---- programs ----------------------------------------------------------
    def _load_params(self, params) -> None:
        """Copy ``params`` into the tensors the captured graph reads."""
        if self._params is None:
            self._params = tree_map(torch.clone, params)
        else:
            tree_map(lambda dst, src: dst.copy_(src), self._params, params)

    def _capture(self) -> torch.cuda.CUDAGraph:
        """One CUDA graph of K decode steps over the lanes: a warm-up step
        on a side stream (cuBLAS handles, workspaces, the allocator), a
        reset, then the capture, which executes nothing."""
        lanes, K = self._lanes, self.slots.steps_per_launch
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            lanes.step(self._params, 0)
        torch.cuda.current_stream(self.device).wait_stream(side)
        lanes.reset()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for j in range(K):
                lanes.step(self._params, j)
        self.watch.captured("chunk")
        return graph

    def chunk_fn(self) -> Callable:
        """``chunk(params)``: K ragged decode steps with their tap rows —
        the captured graph's replay on CUDA (captured on first use, with
        every slot empty), the eager steps otherwise.  Both read the
        lanes' (K, S) ``poison`` mask in place."""
        if self.capture:
            if self._graph is None:
                self._graph = self._capture()
            return lambda params: self._graph.replay()
        lanes, K = self._lanes, self.slots.steps_per_launch

        def chunk(params):
            for j in range(K):
                lanes.step(params, j)
        return chunk

    def admit_fn(self) -> Callable:
        """``admit(slot, pcache, tok0, pos0, rem0, rid, attempt)``:
        in-place index copies into any slot (one program for every
        admission); on a mesh ``slot`` is the rank's own row."""
        return self._lanes.admit

    def prefill_fn(self, prompt_len: int) -> Callable:
        """Batch-1 prefill → (first token (1,), ctx-length cache row);
        cached per prompt length.  On a mesh it runs on the rank's model
        group (the rank's block of the row) and outside the data context:
        one dispatch group, as JAX's prefill of a replicated prompt."""
        fn = self._prefill_fns.get(prompt_len)
        if fn is None:
            cfg, ctx, tp = self.cfg, self.slots.ctx_len, self._tp

            def fn(params, tokens):
                logits, cache = M.prefill(cfg, params, {"tokens": tokens},
                                          ctx_len=ctx, tp=tp)
                return torch.argmax(logits, dim=-1), cache

            self._prefill_fns[prompt_len] = fn
        return fn

    def _restore(self, path: str) -> None:
        """Write a serve snapshot into the lanes' tensors in place (the
        captured graph holds their addresses); on a mesh, the rank's
        blocks of it."""
        from ..checkpoint import checkpointer

        state = self._lanes.state()
        tree_map(lambda dst, src: dst.copy_(src), state,
                 checkpointer.restore(path, state,
                                      shardings=self.state_shardings()))

    # ---- tap ---------------------------------------------------------------
    def _queue_tap(self, chunk: int):
        """Queue the copy of the tap rows to the host; returns (host rows,
        event or None)."""
        lanes = self._lanes
        tap = lanes.tap
        if self._data is not None:    # every rank folds every slot's rows
            tap = all_gather(tap, self._data, dim=2)
        if self.device.type != "cuda":
            return tap.clone(), None
        if self._tap_host is None:
            self._tap_host = [torch.empty(tap.shape, dtype=torch.int64,
                                          pin_memory=True) for _ in range(2)]
        buf = self._tap_host[chunk % 2]
        buf.copy_(tap, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev

    # ---- driver ------------------------------------------------------------
    def serve(self, params, prompts: np.ndarray, max_new: int, *,
              admission: Union[str, AdmissionPolicy] = "pure",
              arrivals: Optional[np.ndarray] = None,
              deadline: Optional[int] = None,
              on_token: Optional[Callable] = None,
              retry: Optional[RetryPolicy] = None,
              overload: Optional[OverloadPolicy] = None,
              drain_after: Optional[int] = None,
              faults=None, snapshot=None,
              resume_from: Optional[str] = None) -> ServeResult:
        """Serve every prompt to its ``max_new``-token budget.

        prompts: (n_requests, prompt_len) integers; ``arrivals``: optional
        (n_requests,) arrival steps on the decode-step clock (see
        :func:`~repro_torch.distributed.admission.draw_arrivals`);
        ``admission``: a policy name / compact spec or a prepared
        :class:`AdmissionPolicy`; ``deadline``: optional queue-wait budget
        in decode steps (a request still queued when ``now − eligible >
        deadline`` times out at the admission sweep and never occupies a
        slot); ``on_token(rid, token, step)`` fires per decoded token, in
        decode order, when the host folds the token's chunk.

        Resilience (each ``None`` leaves a clean serve as it was):

        * ``retry`` (:class:`RetryPolicy`) — evictions and timeouts consume
          attempts and re-queue with deterministic backoff; the emitted
          prefix replays through prefill (``prompt_len + e`` tokens) at
          re-admission.  On the ssm and hybrid families a replay length
          that the SSD chunk does not divide is refused (``ValueError``),
          as in the JAX package.
        * ``overload`` (:class:`OverloadPolicy`) — bounded admission queue;
          eligible waiters beyond ``queue_cap`` are shed.
        * ``drain_after=k`` — at the first sweep with ``t >= k`` every
          queued request is cancelled (``drained``) and only the lanes in
          flight run to completion.
        * ``faults`` (``repro_torch.faults.ServeFaults``-shaped) — poison
          (rid, decode-step) cells to NaN inside the chunk and schedule
          :class:`ServePreempted` at chunk boundaries.
        * ``snapshot`` (:class:`~repro_torch.checkpoint.AsyncSnapshotter`)
          — offer the decode state and the host ledger at every due chunk
          boundary; ``resume_from=dir`` restores such a snapshot and
          continues (``prompts``, ``max_new`` and the knobs must match the
          original call).  On a mesh a snapshotter without shardings is
          given :meth:`state_shardings`, and a snapshot resumes on the
          mesh that wrote it only.
        """
        S, K = self.slots.n_slots, self.slots.steps_per_launch
        prompts = np.asarray(prompts)
        n_req, plen = prompts.shape
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if plen + max_new > self.slots.ctx_len:
            raise ValueError(
                f"prompt_len + max_new = {plen + max_new} exceeds "
                f"ctx_len = {self.slots.ctx_len}")
        if isinstance(admission, AdmissionPolicy):
            policy = admission
        else:
            name, b = parse_admission(admission)
            policy = AdmissionPolicy(name, n_req, b=b, seed=self.slots.seed)
        arr = (np.zeros(n_req, np.int64) if arrivals is None
               else np.asarray(arrivals, np.int64))
        if arr.shape != (n_req,):
            raise ValueError(f"arrivals must be ({n_req},); got {arr.shape}")
        if deadline is not None and deadline < 0:
            raise ValueError(f"deadline must be >= 0 (got {deadline})")
        if drain_after is not None and drain_after < 0:
            raise ValueError(
                f"drain_after must be >= 0 (got {drain_after})")
        for name, val, want in (
                ("retry", retry, RetryPolicy),
                ("overload", overload, OverloadPolicy)):
            if val is not None and not isinstance(val, want):
                raise TypeError(f"{name} must be a {want.__name__}")
        for name, val, attrs in (
                ("faults", faults, ("poisons", "preempt_steps")),
                ("snapshot", snapshot, ("due", "offer", "drain"))):
            if val is not None and not all(hasattr(val, a) for a in attrs):
                raise TypeError(f"{name} must have {', '.join(attrs)}")

        poisons: dict = {}            # decode step -> set of poisoned rids
        preempts: tuple = ()
        if faults is not None:
            for rid_c, st_c in faults.poisons:
                poisons.setdefault(int(st_c), set()).add(int(rid_c))
            preempts = tuple(sorted(int(p) for p in faults.preempt_steps))
        # device-initiated events must be in the ledger at the next sweep
        # for retries and snapshots to be deterministic: fold each chunk
        # before the next sweep; clean serves keep the run-ahead
        sync = (retry is not None or snapshot is not None
                or resume_from is not None or bool(poisons)
                or bool(preempts))

        lanes = self._lanes
        mesh_shape = None if self.mesh is None else dict(self.mesh.shape)
        if (snapshot is not None and self.mesh is not None
                and getattr(snapshot, "shardings", None) is None):
            snapshot.shardings = self.state_shardings()
        lanes.reset()
        if self.capture:
            self._load_params(params)
        chunk = self.chunk_fn()       # a first capture resets the lanes
        admit = self.admit_fn()
        pf = self.prefill_fn(plen)
        prompts_dev = torch.as_tensor(prompts, dtype=torch.int64,
                                      device=self.device)
        cuda = self.device.type == "cuda"

        trace = AdmissionTrace(n_req, wait_b=policy.wait_b)
        resumed_from = None
        if resume_from is not None:
            from ..checkpoint import checkpointer

            meta = checkpointer.load_meta(resume_from)
            if "serve_ledger" not in meta:
                raise ValueError(
                    f"{resume_from} is not a serve snapshot (no ledger)")
            L = _Ledger.from_json(meta["serve_ledger"])
            if len(L.slot_rid) != S or len(L.state_of) != n_req:
                raise ValueError(
                    "snapshot geometry mismatch: ledger has "
                    f"{len(L.slot_rid)} slots / {len(L.state_of)} requests, "
                    f"server has {S} / {n_req}")
            if meta.get("serve_mesh") != mesh_shape:
                raise ValueError(
                    f"snapshot mesh mismatch: {resume_from} was written on "
                    f"mesh {meta.get('serve_mesh')}, this server runs on "
                    f"{mesh_shape}; resume it on the mesh that wrote it")
            policy.load_state(meta["admission_policy"])
            trace.load_state(meta["admission_trace"])
            self._restore(resume_from)
            resumed_from = L.t
        else:
            L = _Ledger(n_req, S, arr)
        rec = self.recorder
        step_maps: dict = {}          # chunk start -> [(rid, fin)] per slot
        req_ns: dict = {}             # rid -> admission's trace ns
        tap_rows = [0]
        mismatches: list = []

        def sink(idx, toks, act, quar):
            tap_rows[0] += 1
            m = step_maps[idx - idx % K]
            for s, (rid, fin_s) in enumerate(m):
                if quar[s]:
                    if rid < 0:
                        mismatches.append(
                            f"step {idx} slot {s}: quarantine on an empty "
                            "lane")
                        continue
                    if rid not in L.cur_evict:
                        L.cur_evict[rid] = int(idx)
                        L.evict_events.append([rid, int(idx)])
                        if rec is not None:
                            rec.instant("evict", lane="faults", rid=rid,
                                        step=int(idx))
                            rec.count("evictions")
                ev = L.cur_evict.get(rid) if rid >= 0 else None
                predicted = (rid >= 0 and idx < fin_s
                             and (ev is None or idx < ev))
                if bool(act[s]) != predicted:
                    mismatches.append(
                        f"step {idx} slot {s}: device active={bool(act[s])} "
                        f"!= host-predicted {predicted}")
                    continue
                if predicted:
                    tok = int(toks[s])
                    L.outputs[rid].append(tok)
                    if on_token is not None:
                        on_token(rid, tok, int(idx))

        host_waits = [0]

        def fold(pending):
            """Fold one chunk's tap rows into the ledger."""
            t0, rows, ev = pending
            if ev is not None and not ev.query():
                host_waits[0] += 1
                ev.synchronize()
            rows = rows.numpy()
            for j in range(K):
                sink(t0 + j, rows[j, 0], rows[j, 1] != 0, rows[j, 2] != 0)

        def ledger_meta():
            meta = {"serve_ledger": L.to_json(),
                    "admission_policy": policy.state_dict(),
                    "admission_trace": trace.state_dict()}
            if mesh_shape is not None:
                meta["serve_mesh"] = mesh_shape
            return meta

        def drain_events():
            """Fold tap-recorded quarantine evictions into the ledger."""
            while L.evt_cursor < len(L.evict_events):
                rid, step = L.evict_events[L.evt_cursor]
                L.evt_cursor += 1
                if retry is None:
                    # the lane stays booked until its scheduled completion;
                    # the eviction is terminal metadata
                    if rid not in L.evictions:
                        L.evictions[rid] = step
                        trace.evicted(rid, step)
                    continue
                # retry: the attempt failed — free the frozen lane now
                for s in range(S):
                    if L.slot_rid[s] == rid:
                        L.slot_rid[s] = -1
                req_ns.pop(rid, None)
                row = L.outputs.pop(rid, None)
                if row is not None:
                    L.emitted[rid] = (L.emitted.get(rid, [])
                                      + [_tok_int(x) for x in row])
                L.cur_evict.pop(rid, None)
                tries = L.tries[rid] = L.tries.get(rid, 0) + 1
                trace.retried(rid, tries)
                if (tries < retry.max_attempts
                        and len(L.emitted.get(rid, [])) < max_new):
                    L.state_of[rid] = "queued"
                    L.eligible[rid] = step + retry.backoff_steps(tries)
                    policy.requeue(rid)
                    if rec is not None:
                        rec.instant("retry", lane="server", rid=rid,
                                    step=step, attempt=tries)
                        rec.count("retries")
                else:
                    L.state_of[rid] = "done"
                    L.evictions[rid] = step
                    trace.evicted(rid, step)
                    policy.cancel(rid)

        t = L.t
        start_t0 = L.t                # resumed: earlier preemptions spent
        chunks_run = 0                # this serve's launches
        last_offered = None
        pending = None                # the chunk whose tap rows are in flight
        drain_ns = None
        events = []                   # (start, end) CUDA events per chunk
        attempts_bound = retry.max_attempts if retry is not None else 1
        backoff_total = (sum(retry.backoff_steps(f)
                             for f in range(1, attempts_bound))
                         if retry is not None else 0)
        horizon = 2 * (int(arr.max(initial=0))
                       + n_req * (max_new * attempts_bound + backoff_total)
                       + K) + 4 * K
        while L.done < n_req:
            if t > horizon:
                raise RuntimeError(
                    f"slot loop passed its horizon ({horizon} steps) with "
                    f"{n_req - L.done} requests unfinished — admission "
                    "bookkeeping is stuck")
            sweep0 = rec.now_ns() if rec is not None else 0
            drain_events()
            # -- scheduled driver preemption -------------------------------
            if preempts:
                due_p = next((p for p in preempts if start_t0 < p <= t), None)
                if due_p is not None:
                    if snapshot is not None:
                        if last_offered != t:
                            snapshot.offer(t, lanes.state(),
                                           meta=ledger_meta())
                        snapshot.drain()
                    raise ServePreempted(t, due_p)
            # -- completions (deterministic, no readback) ------------------
            freed = sorted(
                (s for s in range(S)
                 if L.slot_rid[s] >= 0 and L.fin[L.slot_rid[s]] <= t),
                key=lambda s: (L.fin[L.slot_rid[s]], s))
            for s in freed:
                rid, L.slot_rid[s] = L.slot_rid[s], -1
                L.state_of[rid] = "done"
                trace.completed(rid, s, L.fin[rid], L.in_flight + 1)
                policy.notify_completion(rid)
                if rec is not None and rid in req_ns:
                    # the request's lifetime on its slot's own lane
                    rec.span_at("request", f"slot{s}", req_ns.pop(rid),
                                rec.now_ns(), rid=rid,
                                steps=L.fin[rid] - L.admit_t[rid] + 1)
                    rec.count("completions")
            # -- graceful drain (stop admitting, finish in-flight) ---------
            if (drain_after is not None and t >= drain_after
                    and L.drain_t is None):
                L.drain_t = t
                drain_ns = rec.now_ns() if rec is not None else None
                for r in sorted(L.state_of):
                    if L.state_of[r] == "queued":
                        L.state_of[r] = "done"
                        L.drained[r] = t
                        trace.drained(r, t)
                        policy.cancel(r)
                if rec is not None:
                    rec.instant("drain_start", lane="server", step=t,
                                cancelled=len(L.drained),
                                in_flight=L.in_flight)
                    rec.count("drained", len(L.drained))
            # -- deadline timeouts (queue-wait budget) ---------------------
            if deadline is not None:
                for r in range(n_req):
                    if L.state_of[r] != "queued":
                        continue
                    el = L.eligible[r]
                    if el <= t and t - el > deadline:
                        if retry is not None:
                            tries = L.tries[r] = L.tries.get(r, 0) + 1
                            trace.retried(r, tries)
                            if tries < retry.max_attempts:
                                L.eligible[r] = t + retry.backoff_steps(tries)
                                if rec is not None:
                                    rec.instant("retry", lane="server",
                                                rid=r, step=t, attempt=tries)
                                    rec.count("retries")
                                continue
                        L.timeouts[r] = t
                        L.state_of[r] = "done"
                        policy.cancel(r)
                        trace.timed_out(r, t)
                        if rec is not None:
                            rec.instant("timeout", lane="server", rid=r,
                                        step=t, wait=t - int(el))
                            rec.count("timeouts")
            # -- admissions into free slots --------------------------------
            arrived = {r for r, st_r in L.state_of.items()
                       if st_r == "queued" and L.eligible[r] <= t}
            free = [s for s in range(S) if L.slot_rid[s] < 0]
            admitted = []             # (rid, first token | None), in order
            while free:
                rid = policy.pick(arrived, L.in_flight)
                if rid is None:
                    break
                s = free[0]
                pre = L.emitted.get(rid, [])
                e = len(pre)
                if e:
                    # replay the recovered prefix: re-prefill
                    # prompt + tokens emitted so far
                    pf_e = self.prefill_fn(plen + e)
                    ptoks = torch.as_tensor(
                        np.concatenate([prompts[rid], pre])[None],
                        dtype=torch.int64, device=self.device)
                else:
                    pf_e, ptoks = pf, prompts_dev[rid:rid + 1]
                rem0 = max_new - 1 - e
                tok0 = None
                local = s - lanes.lo
                if 0 <= local < lanes.n:          # this data rank's slot
                    with _span(rec, "prefill", "server", rid=rid,
                               plen=plen + e):
                        tok0, pcache = pf_e(params, ptoks)
                    with _span(rec, "admit", "server", rid=rid, slot=s):
                        admit(local, pcache, tok0, plen + e, rem0, rid,
                              L.tries.get(rid, 0))
                admitted.append((rid, tok0))
                L.outputs[rid] = [tok0]
                L.admit_t.setdefault(rid, t)
                L.fin[rid] = t + rem0
                trace.admitted(rid, t)
                arrived.discard(rid)
                if rec is not None:
                    rec.hist("ttft_steps", t - int(arr[rid]))
                    req_ns[rid] = rec.now_ns()
                if rem0 == 0:         # budget already emitted: completes
                    L.state_of[rid] = "done"          # at admission
                    trace.completed(rid, s, t, L.in_flight + 1)
                    policy.notify_completion(rid)
                    if rec is not None and rid in req_ns:
                        rec.span_at("request", f"slot{s}", req_ns.pop(rid),
                                    rec.now_ns(), rid=rid, steps=1)
                        rec.count("completions")
                else:
                    L.slot_rid[s] = rid
                    L.state_of[rid] = "inflight"
                    free.pop(0)
            if self._data is not None and admitted:
                # the owners' first tokens to every data rank, one
                # all-reduce (zeros where a rank does not own the slot)
                firsts = torch.zeros(len(admitted), dtype=torch.int64,
                                     device=self.device)
                for i, (rid, tok0) in enumerate(admitted):
                    if tok0 is not None:
                        firsts[i:i + 1].copy_(tok0)
                firsts = all_reduce(firsts, self._data)
                for i, (rid, _) in enumerate(admitted):
                    L.outputs[rid][0] = firsts[i:i + 1]
            # -- overload shedding (bounded admission queue) ---------------
            if overload is not None:
                waiting = sorted(
                    (r for r, st_r in L.state_of.items()
                     if st_r == "queued" and L.eligible[r] <= t),
                    key=lambda r: (L.eligible[r], r))
                excess = len(waiting) - overload.queue_cap
                if excess > 0:
                    victims = (waiting[-excess:]
                               if overload.shed == "reject-new"
                               else waiting[:excess])
                    for r in victims:
                        L.state_of[r] = "done"
                        L.shed[r] = t
                        trace.shed(r, t)
                        policy.cancel(r)
                        if rec is not None:
                            rec.instant("shed", lane="server", rid=r,
                                        step=t, policy=overload.shed)
                            rec.count("shed")
            if rec is not None:
                rec.span_at("admission_sweep", "server", sweep0,
                            rec.now_ns(), t=t)
                rec.gauge("in_flight", L.in_flight, lane="server")
                rec.gauge("occupancy", L.in_flight / S, lane="server")
            if L.done >= n_req:
                break
            if L.in_flight == 0:
                # idle pool, pending arrivals or backoffs: fast-forward the
                # clock to the next chunk boundary at/after the earliest
                # eligibility
                nxt = min(L.eligible[r] for r, st_r in L.state_of.items()
                          if st_r == "queued")
                t = max(t + K, -(-int(nxt) // K) * K)
                L.t = t
                continue
            # -- one chunk launch ------------------------------------------
            step_maps[t] = [(rid, L.fin.get(rid, -1)) for rid in L.slot_rid]
            for s in range(S):
                rid = L.slot_rid[s]
                if rid >= 0:
                    L.busy_steps += max(0, min(t + K, L.fin[rid]) - t)
            mask = np.zeros((K, S), bool)
            for j in range(K):
                cells = poisons.get(t + j)
                if cells:
                    mask[j] = [L.slot_rid[s] in cells for s in range(S)]
            mask = mask[:, lanes.lo:lanes.lo + lanes.n]    # this rank's rows
            poisoned = bool(mask.any())
            if poisoned:
                lanes.poison.copy_(torch.from_numpy(mask))
            with _span(rec, "launch", "server", t=t, in_flight=L.in_flight):
                if cuda:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                chunk(params)
                if cuda:
                    ev[1].record()
                    events.append(ev)
            if poisoned:
                lanes.poison.zero_()
            rows = self._queue_tap(L.chunks)
            L.chunks += 1
            chunks_run += 1
            if pending is not None:
                fold(pending)         # the previous chunk, one behind
            pending = (t, *rows)
            t += K
            L.t = t
            if sync:
                with _span(rec, "chunk_barrier", "server", t=t):
                    fold(pending)
                pending = None
            if snapshot is not None and snapshot.due(t, 1 << 62):
                drain_events()        # the ledger holds the folded rows
                snapshot.offer(t, lanes.state(), meta=ledger_meta())
                last_offered = t
        with _span(rec, "barrier", "server"):
            if pending is not None:
                fold(pending)
        drain_events()

        if mismatches:
            raise RuntimeError(
                "device masks diverged from host bookkeeping:\n  "
                + "\n  ".join(mismatches[:10]))
        if tap_rows[0] != chunks_run * K:
            raise RuntimeError(f"serve tap delivered {tap_rows[0]}/"
                               f"{chunks_run * K} rows")
        deferred = sorted(r for r, row in L.outputs.items()
                          if isinstance(row[0], torch.Tensor))
        if deferred:                  # the deferred first tokens, one read
            vals = torch.cat([L.outputs[r][0] for r in deferred]).tolist()
            for r, v in zip(deferred, vals):
                L.outputs[r][0] = int(v)
        toks = np.full((n_req, max_new), -1, np.int32)
        for rid in range(n_req):
            parts = L.emitted.get(rid, []) + L.outputs.get(rid, [])
            failed = (rid in L.evictions or rid in L.timeouts
                      or rid in L.shed or rid in L.drained)
            if failed:
                if len(parts) > max_new:
                    raise RuntimeError(
                        f"request {rid} streamed {len(parts)} tokens past "
                        f"its {max_new} budget despite degradation")
                toks[rid, :len(parts)] = parts   # −1 from the failure on
            else:
                if len(parts) != max_new:
                    raise RuntimeError(
                        f"request {rid} streamed {len(parts)}/{max_new} "
                        "tokens")
                toks[rid] = parts
        ttft = np.array([L.admit_t[r] - arr[r] if r in L.admit_t else -1
                         for r in range(n_req)], np.int64)
        occ = (L.busy_steps / (L.chunks * K * S)) if L.chunks else 0.0
        chunk_ms = (sum(a.elapsed_time(b) for a, b in events)
                    if cuda else None)
        if rec is not None:
            rec.count("requests", n_req)
            rec.count("serve_chunks", chunks_run)
            rec.count("serve_decode_steps", chunks_run * K)
            rec.count("serve_tap_rows", tap_rows[0])
            rec.gauge("occupancy_mean", float(occ), lane="server")
            if L.drain_t is not None and drain_ns is not None:
                rec.span_at("drain", "server", drain_ns, rec.now_ns(),
                            t=L.drain_t, cancelled=len(L.drained))
                rec.gauge("drain_final_occupancy", L.in_flight / S,
                          lane="server")
        return ServeResult(tokens=toks, schedule=trace.schedule(),
                           ttft_steps=ttft, occupancy=float(occ),
                           decode_steps=L.chunks * K, chunks=L.chunks,
                           tap_rows=tap_rows[0],
                           evictions=dict(L.evictions),
                           timeouts=dict(L.timeouts),
                           shed=dict(L.shed), drained=dict(L.drained),
                           attempts=trace.attempts,
                           resumed_from=resumed_from,
                           host_waits=host_waits[0],
                           chunk_device_ms=chunk_ms)
