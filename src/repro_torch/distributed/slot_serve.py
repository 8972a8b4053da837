"""Slot-based continuous-batching serving: one captured ragged decode chunk.

Counterpart of ``repro/distributed/slot_serve.py`` (PR 7/8 semantics) on
one device.  ``n_slots`` persistent decode lanes, each with its own
position, activity and budget, are stepped by ONE program:

* **Device.**  The decode state (the ragged cache of
  ``models.init_cache(..., ragged=True)``, and per slot the last token,
  position, activity, remaining budget, request id and sampling counter) is
  a set of tensors allocated once per server and updated in place.  A
  chunk of ``steps_per_launch`` (K) ragged ``models.decode_step`` calls
  runs over it: inactive slots freeze (token, position and budget held by
  the activity mask) and their ring re-writes are idempotent, so masking
  replaces control flow.  On CUDA the chunk is captured once as a
  ``torch.cuda.CUDAGraph`` (the counterpart of JAX's one ``jit`` of a
  ``lax.scan``) and replayed for every chunk of every serve; the graph
  reads the server's own copy of the params, refreshed at each serve.
  ``capture=False`` runs the same steps eagerly: the CPU route, and the
  card's yardstick for graph ≡ eager.
* **Tap.**  Each step writes its (tokens, active, quarantined) row into a
  (K, 3, n_slots) device buffer.  After each chunk a non-blocking copy
  into pinned host memory is queued with an event; the host folds chunk
  c's rows into the ledger after it has queued chunk c + 1, so a clean
  serve keeps one chunk of run-ahead.  The host counts how often it had to
  wait for a row (``ServeResult.host_waits``).  This is the port's form of
  the JAX package's ordered ``io_callback``.
* **Host.**  With a fixed per-request token budget there is no
  content-dependent exit: admissions, completions, occupancy and TTFT are
  bookkeeping, and no device value steers the loop.  Admission (which
  queued request fills a freed slot, at chunk boundaries) is a registry
  scheduler via :class:`~repro_torch.distributed.admission.AdmissionPolicy`,
  and the realised trace lowers to an ordinary ``Schedule``.
* **Prefill** per admitted request: an eager batch-1 prefill at the prompt
  length (the path's kernel work: the flash kernel on the dense family,
  the SSD kernel on the ssm family) gives the first token and a cache row,
  which in-place index copies write into the request's slot.
* **Sampling** (``temperature > 0``) is Gumbel-max over a counter-based
  integer hash of (seed, request id, decode step within the request,
  vocabulary index), computed with torch ops inside the chunk.  A
  request's stream is a pure function of those, whatever its slot or the
  pool width.  The streams are the port's own: JAX's threefry keys cannot
  be reproduced, and one ``torch.Generator`` cannot give per-slot streams
  inside one graph.
* **Degradation is masked, not crashed**: an active lane whose logits go
  non-finite is quarantined on the device (budget zeroed, no token) and
  the host learns of it from the tap; queued requests whose wait exceeds
  a ``deadline`` time out at admission sweeps.

The resilience layer of the JAX server (retry, overload shedding, drain,
serve faults, snapshots and resume) and its recorder are not ported: their
arguments raise ``NotImplementedError``.  :class:`OverloadPolicy` is
copied so that ``ServeJob`` validates its fields as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models import model as M
from ..tree import tree_leaves, tree_map
from .admission import AdmissionPolicy, AdmissionTrace, parse_admission

_RESILIENCE = ("is serving resilience, not ported yet (ROADMAP.md queue 1, "
               "item 11c)")


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


SHED_POLICIES = ("reject-new", "drop-oldest")


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Bounded admission queue (the JAX package's fields and validation;
    shedding itself is not ported)."""

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


@dataclasses.dataclass
class ServeResult:
    """Per-request token matrix + the realised admission world.

    An evicted request's ``tokens`` row holds −1 from its quarantine point
    on; a timed-out request was never admitted and has an all −1 row and a
    −1 ``ttft_steps`` entry.
    """

    tokens: np.ndarray           # (n_requests, max_new) int32, −1 padded
    schedule: object             # repro_torch.core.engine.Schedule
    ttft_steps: np.ndarray       # (n_requests,) admission − arrival (steps)
    occupancy: float             # mean fraction of busy slot-steps
    decode_steps: int            # launched decode steps
    chunks: int                  # chunk launches (graph replays on CUDA)
    tap_rows: int                # tap rows folded into the ledger
    evictions: dict = dataclasses.field(default_factory=dict)
    timeouts: dict = dataclasses.field(default_factory=dict)
    #: times the host found a chunk's tap rows not yet on the host and
    #: waited for them (0 when the device never fell behind the host)
    host_waits: int = 0
    #: device time of the chunks, CUDA events around each launch (ms;
    #: None off CUDA)
    chunk_device_ms: Optional[float] = None


class _Ledger:
    """Host-side bookkeeping of one serve run.  Request lifecycle:
    ``queued`` (``eligible[rid]`` = step it may be admitted from) →
    ``inflight`` (occupies a slot, ``fin[rid]`` = its completion step) →
    ``done`` (completed or terminally failed)."""

    def __init__(self, n_req: int, n_slots: int, arrivals):
        self.chunks = 0
        self.busy_steps = 0
        self.slot_rid = [-1] * n_slots
        self.state_of = {r: "queued" for r in range(n_req)}
        self.eligible = {r: int(arrivals[r]) for r in range(n_req)}
        self.fin = {}          # rid -> completion step
        self.admit_t = {}      # rid -> admission step (ttft)
        self.outputs = {}      # rid -> [tok0 (device), ints...]
        self.cur_evict = {}    # rid -> quarantine step (tap-written)
        self.evict_events = []  # [rid, step] in tap order
        self.evt_cursor = 0    # events before it are host-processed
        self.evictions = {}    # terminal accounting maps (rid -> step)
        self.timeouts = {}

    @property
    def in_flight(self) -> int:
        return sum(1 for v in self.state_of.values() if v == "inflight")

    @property
    def done(self) -> int:
        return sum(1 for v in self.state_of.values() if v == "done")


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
    one ragged decode step over them, written in place."""

    def __init__(self, cfg: ArchConfig, slots: SlotConfig, device):
        S, K = slots.n_slots, slots.steps_per_launch
        self.cfg, self.slots = cfg, slots
        self.cache = M.init_cache(cfg, S, slots.ctx_len, device, ragged=True)
        i64 = dict(dtype=torch.int64, device=device)
        self.toks = torch.zeros(S, **i64)
        self.pos = torch.zeros(S, dtype=torch.int32, device=device)
        self.active = torch.zeros(S, dtype=torch.bool, device=device)
        self.remaining = torch.zeros(S, **i64)
        self.rid = torch.zeros(S, **i64)             # sampling stream id
        self.ctr = torch.zeros(S, **i64)             # decode step in request
        #: (K, S) fault mask, all false: kept for the serve faults (item 11c)
        self.poison = torch.zeros((K, S), dtype=torch.bool, device=device)
        #: (K, 3, S) tap rows: tokens, active, quarantined
        self.tap = torch.zeros((K, 3, S), **i64)
        self.vocab_idx = torch.arange(cfg.vocab, **i64)
        self.seed_h = _mix32(int(slots.seed) & _M32)

    def reset(self) -> None:
        """Every slot empty: inactive lanes decode and discard until a
        request is admitted."""
        for leaf in tree_leaves(self.cache):
            leaf.zero_()
        if "positions" in self.cache:
            self.cache["positions"].fill_(-1)
        for t in (self.toks, self.pos, self.active, self.remaining,
                  self.rid, self.ctr, self.tap):
            t.zero_()

    def admit(self, slot: int, pcache: dict, tok0, pos0: int, rem0: int,
              rid: int) -> None:
        """Write a batch-1 prefill's cache row and first token into
        ``slot``, in place."""
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

    def _sample(self, logits):
        """Gumbel-max over the (seed, rid, step, vocab index) hash."""
        h = _mix32(_mix32(self.seed_h ^ self.rid) ^ self.ctr)       # (S,)
        bits = _mix32(h[:, None] ^ self.vocab_idx[None, :])          # (S, V)
        u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.float() / self.slots.temperature + gumbel,
                            dim=-1)

    def step(self, params, j: int) -> None:
        """Decode step ``j`` of a chunk: every lane decodes, active lanes
        with finite logits emit, non-finite ones are quarantined."""
        logits, _ = M.decode_step(self.cfg, params, self.cache, self.toks,
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
    the card too."""

    def __init__(self, cfg: ArchConfig, slots: SlotConfig, device="cuda",
                 capture: bool = True, recorder=None):
        if cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"slot serving admits token-only prompts; the {cfg.family!r} "
                "family needs per-request modality inputs (follow-up)")
        if recorder is not None:
            raise NotImplementedError(
                "a serve recorder is observability, not ported yet "
                "(ROADMAP.md queue 1, item 12)")
        self.cfg, self.slots = cfg, slots
        self.device = resolve_device(device)
        self.capture = capture and self.device.type == "cuda"
        self._lanes = _Lanes(cfg, slots, self.device)
        self._captures = 0
        self._graph = None            # the captured chunk
        self._params = None           # the graph's copy of the params
        self._prefill_fns = {}        # prompt_len -> batch-1 prefill
        self._tap_host = None         # two host buffers for the tap rows

    def compile_counts(self) -> dict:
        """How often each program was built: ``chunk``, the captures of the
        chunk's CUDA graph (0 on the eager route).  Rotating requests
        through freed slots and serving again keep it at 1.  Admission and
        prefill run eagerly, so nothing of theirs is built."""
        return {"chunk": self._captures}

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
        self._captures += 1
        return graph

    def chunk_fn(self) -> Callable:
        """``chunk(params)``: K ragged decode steps with their tap rows —
        the captured graph's replay on CUDA (captured on first use, with
        every slot empty), the eager steps otherwise."""
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
        """``admit(slot, pcache, tok0, pos0, rem0, rid)``: in-place index
        copies into any slot (one program for every admission)."""
        return self._lanes.admit

    def prefill_fn(self, prompt_len: int) -> Callable:
        """Batch-1 prefill → (first token (1,), ctx-length cache row);
        cached per prompt length."""
        fn = self._prefill_fns.get(prompt_len)
        if fn is None:
            cfg, ctx = self.cfg, self.slots.ctx_len

            def fn(params, tokens):
                logits, cache = M.prefill(cfg, params, {"tokens": tokens},
                                          ctx_len=ctx)
                return torch.argmax(logits, dim=-1), cache

            self._prefill_fns[prompt_len] = fn
        return fn

    # ---- tap ---------------------------------------------------------------
    def _queue_tap(self, chunk: int):
        """Queue the copy of the tap rows to the host; returns (host rows,
        event or None)."""
        lanes = self._lanes
        if self.device.type != "cuda":
            return lanes.tap.clone(), None
        if self._tap_host is None:
            self._tap_host = [torch.empty(lanes.tap.shape, dtype=torch.int64,
                                          pin_memory=True) for _ in range(2)]
        buf = self._tap_host[chunk % 2]
        buf.copy_(lanes.tap, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev

    # ---- driver ------------------------------------------------------------
    def serve(self, params, prompts: np.ndarray, max_new: int, *,
              admission: Union[str, AdmissionPolicy] = "pure",
              arrivals: Optional[np.ndarray] = None,
              deadline: Optional[int] = None,
              on_token: Optional[Callable] = None,
              retry=None, overload=None, drain_after: Optional[int] = None,
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

        ``retry``, ``overload``, ``drain_after``, ``faults``, ``snapshot``
        and ``resume_from`` raise ``NotImplementedError``.
        """
        for name, val in (("retry", retry), ("overload", overload),
                          ("drain_after", drain_after), ("faults", faults),
                          ("snapshot", snapshot),
                          ("resume_from", resume_from)):
            if val is not None:
                raise NotImplementedError(f"serve({name}=...) {_RESILIENCE}")
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

        lanes = self._lanes
        lanes.reset()
        if self.capture:
            self._load_params(params)
        chunk = self.chunk_fn()
        admit = self.admit_fn()
        pf = self.prefill_fn(plen)
        prompts_dev = torch.as_tensor(prompts, dtype=torch.int64,
                                      device=self.device)
        cuda = self.device.type == "cuda"

        trace = AdmissionTrace(n_req, wait_b=policy.wait_b)
        L = _Ledger(n_req, S, arr)
        step_maps: dict = {}          # chunk start -> [(rid, fin)] per slot
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

        def drain_events():
            """Fold tap-recorded quarantine evictions into the ledger: the
            lane stays booked until its scheduled completion, the eviction
            is terminal metadata."""
            while L.evt_cursor < len(L.evict_events):
                rid, step = L.evict_events[L.evt_cursor]
                L.evt_cursor += 1
                if rid not in L.evictions:
                    L.evictions[rid] = step
                    trace.evicted(rid, step)

        t = 0
        pending = None                # the chunk whose tap rows are in flight
        events = []                   # (start, end) CUDA events per chunk
        horizon = 2 * (int(arr.max(initial=0)) + n_req * max_new + K) + 4 * K
        while L.done < n_req:
            if t > horizon:
                raise RuntimeError(
                    f"slot loop passed its horizon ({horizon} steps) with "
                    f"{n_req - L.done} requests unfinished — admission "
                    "bookkeeping is stuck")
            drain_events()
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
            # -- deadline timeouts (queue-wait budget) ---------------------
            if deadline is not None:
                for r in range(n_req):
                    if L.state_of[r] != "queued":
                        continue
                    el = L.eligible[r]
                    if el <= t and t - el > deadline:
                        L.timeouts[r] = t
                        L.state_of[r] = "done"
                        policy.cancel(r)
                        trace.timed_out(r, t)
            # -- admissions into free slots --------------------------------
            arrived = {r for r, st_r in L.state_of.items()
                       if st_r == "queued" and L.eligible[r] <= t}
            free = [s for s in range(S) if L.slot_rid[s] < 0]
            while free:
                rid = policy.pick(arrived, L.in_flight)
                if rid is None:
                    break
                s = free[0]
                rem0 = max_new - 1
                tok0, pcache = pf(params, prompts_dev[rid:rid + 1])
                admit(s, pcache, tok0, plen, rem0, rid)
                L.outputs[rid] = [tok0]
                L.admit_t[rid] = t
                L.fin[rid] = t + rem0
                trace.admitted(rid, t)
                arrived.discard(rid)
                if rem0 == 0:         # budget already emitted: completes
                    L.state_of[rid] = "done"          # at admission
                    trace.completed(rid, s, t, L.in_flight + 1)
                    policy.notify_completion(rid)
                else:
                    L.slot_rid[s] = rid
                    L.state_of[rid] = "inflight"
                    free.pop(0)
            if L.done >= n_req:
                break
            if L.in_flight == 0:
                # idle pool, pending arrivals: fast-forward the clock to the
                # next chunk boundary at/after the earliest eligibility
                nxt = min(L.eligible[r] for r, st_r in L.state_of.items()
                          if st_r == "queued")
                t = max(t + K, -(-int(nxt) // K) * K)
                continue
            # -- one chunk launch ------------------------------------------
            step_maps[t] = [(rid, L.fin.get(rid, -1)) for rid in L.slot_rid]
            for s in range(S):
                rid = L.slot_rid[s]
                if rid >= 0:
                    L.busy_steps += max(0, min(t + K, L.fin[rid]) - t)
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            chunk(params)
            if cuda:
                ev[1].record()
                events.append(ev)
            rows = self._queue_tap(L.chunks)
            L.chunks += 1
            if pending is not None:
                fold(pending)         # the previous chunk, one behind
            pending = (t, *rows)
            t += K
        if pending is not None:
            fold(pending)
        drain_events()

        if mismatches:
            raise RuntimeError(
                "device masks diverged from host bookkeeping:\n  "
                + "\n  ".join(mismatches[:10]))
        if tap_rows[0] != L.chunks * K:
            raise RuntimeError(f"serve tap delivered {tap_rows[0]}/"
                               f"{L.chunks * K} rows")
        firsts = {}
        rids = sorted(L.outputs)
        if rids:                      # the deferred first tokens, one read
            vals = torch.cat([L.outputs[r][0] for r in rids]).cpu().tolist()
            firsts = dict(zip(rids, vals))
        toks = np.full((n_req, max_new), -1, np.int32)
        for rid in range(n_req):
            row = L.outputs.get(rid)
            parts = [] if row is None else [firsts[rid]] + row[1:]
            if rid in L.evictions or rid in L.timeouts:
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
        return ServeResult(tokens=toks, schedule=trace.schedule(),
                           ttft_steps=ttft, occupancy=float(occ),
                           decode_steps=L.chunks * K, chunks=L.chunks,
                           tap_rows=tap_rows[0],
                           evictions=dict(L.evictions),
                           timeouts=dict(L.timeouts),
                           host_waits=host_waits[0],
                           chunk_device_ms=chunk_ms)
