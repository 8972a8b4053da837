"""Deterministic fault transforms — injectable failure as a scenario.

Faults are scheduled world transforms, exactly like stragglers or
elastic membership (Maranjyan's optimal-scheduling line, arXiv:2601.02523,
treats worker failure as a first-class scheduled event): each one
precomputes its whole trajectory from the realisation seed in
``prepare``, lowers into ``RunPlan`` channels, and therefore replays
bit-for-bit under scan ≡ eager.

Channels:

* ``fault_gain`` — a (rounds, n) multiplicative gain on each worker's
  received contribution: the participation-weighted mean gain scales the
  round's post-normalisation loss and gradients (scaling example weights
  alone would cancel in the CE's weight normalisation).  ``1.0`` is
  neutral; :class:`CorruptReceipt` plants a huge finite gain (an
  inflated, garbage receipt — spikes the loss/norm, exercising clipping,
  the spike check and the breaker); :class:`NanGrad` plants ``NaN``
  (poisons the loss/gradients of every round that worker participates
  in — exercises the non-finite skip guard).  Gains of non-participating
  workers are ignored (the gate forces them to 1 before the mean).
* ``availability`` — :class:`WorkerCrash` reuses the elastic membership
  channel for a one-off scheduled crash window (vs. elastic's recurring
  dropout/rejoin), optionally permanent.
* ``preempt_rounds`` — :class:`HostPreempt` is host-level metadata, not
  a device channel: the rounds at which the *driver process* should be
  killed.  Tests and the crash-resume gate read it to schedule SIGKILL;
  the compiled program never sees it.

Serving-lane faults run on the DECODE-STEP clock instead of the round
clock (``prepare`` receives ``n = n_requests`` and ``rounds = horizon``
in decode steps):

* ``serve_poisons`` — :class:`SlotPoison` names (rid, decode-step) cells
  whose logits the slot server forces to NaN before its finite check:
  the lane quarantines exactly there, deterministically, driving the
  retry/re-admission path end-to-end.
* ``serve_preempt_steps`` — :class:`ServePreempt` is the serve driver's
  ``host_preempt``: decode-step boundaries where the driver dies.  The
  in-process harness raises ``ServePreempted`` there (after forcing a
  snapshot offer); the SIGKILL gate kills a real subprocess.

:func:`realise_serve_faults` lowers any scenario spec string to a
:class:`ServeFaults` bundle (non-serve transforms contribute nothing),
which ``SlotServer.serve(faults=...)`` consumes.

Grammar (same ``name:k=v,...`` spec strings as every other transform)::

    nan_grad:k=1,every=16,span=1
    corrupt_receipt:k=1,scale=1e4,every=16,span=1
    worker_crash:k=1,at=16,span=16,permanent=1
    host_preempt:at=32
    slot_poison:rid=1,step=4,every=0
    serve_preempt:at=16,every=0

Importing this module registers the names into
``repro.scenarios.TRANSFORMS`` (``repro.scenarios`` imports it, so any
path that can parse a spec string already knows them).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..scenarios.transforms import TRANSFORMS, WorldTransform, _windows


class NanGrad(WorldTransform):
    """Poisoned receipts: every ``every`` rounds, ``k`` workers (chosen
    per window from the realisation RNG) return non-finite gradients for
    ``span`` rounds.  Without guards the first hit permanently NaNs the
    params; with guards those rounds are skipped and health backs off."""

    name = "nan_grad"

    def __init__(self, k: int = 1, every: int = 16, span: int = 1):
        if k < 1 or every < 1 or span < 1:
            raise ValueError("nan_grad k/every/span must be >= 1")
        self.k = int(k)
        self.every = int(every)
        self.span = int(span)

    def prepare(self, n, rounds, rng):
        gain = np.ones((max(rounds, 1), n), dtype=np.float32)
        k = min(self.k, n)
        for lo, hi in _windows(max(rounds, 1), self.every, self.span):
            hit = rng.choice(n, size=k, replace=False)
            gain[lo:hi, hit] = np.nan
        self._gain = gain

    def fault_gain(self):
        return self._gain


class CorruptReceipt(WorldTransform):
    """Garbage-but-finite receipts: flagged (round, worker) cells scale
    that worker's loss contribution by ``scale`` — an inflated gradient
    that stays finite, so it passes the non-finite guard but spikes the
    loss/norm (exercising clipping, the spike check, and the breaker)."""

    name = "corrupt_receipt"

    def __init__(self, k: int = 1, scale: float = 1e4, every: int = 16,
                 span: int = 1):
        if k < 1 or every < 1 or span < 1:
            raise ValueError("corrupt_receipt k/every/span must be >= 1")
        if not np.isfinite(scale) or scale <= 0 or scale == 1.0:
            raise ValueError(
                f"corrupt_receipt scale must be finite, positive and != 1 "
                f"(got {scale}); use nan_grad for non-finite faults")
        self.k = int(k)
        self.scale = float(scale)
        self.every = int(every)
        self.span = int(span)

    def prepare(self, n, rounds, rng):
        gain = np.ones((max(rounds, 1), n), dtype=np.float32)
        k = min(self.k, n)
        for lo, hi in _windows(max(rounds, 1), self.every, self.span):
            hit = rng.choice(n, size=k, replace=False)
            gain[lo:hi, hit] = self.scale
        self._gain = gain

    def fault_gain(self):
        return self._gain


class WorkerCrash(WorldTransform):
    """One-off scheduled crash: ``k`` workers (chosen from the
    realisation RNG) go down at round ``at`` for ``span`` rounds — or for
    the rest of the run with ``permanent=1`` — via the same availability
    channel elastic membership uses (scheduler remap + hard mask drop).
    Never takes down the whole pool."""

    name = "worker_crash"

    def __init__(self, k: int = 1, at: int = 16, span: int = 16,
                 permanent: int = 0):
        if k < 1 or at < 1 or span < 1:
            raise ValueError("worker_crash k/at/span must be >= 1 "
                             "(round 0 stays clean)")
        self.k = int(k)
        self.at = int(at)
        self.span = int(span)
        self.permanent = bool(permanent)

    def prepare(self, n, rounds, rng):
        avail = np.ones((max(rounds, 1), n), dtype=np.float32)
        k = min(self.k, max(n - 1, 1))      # never crash the whole pool
        down = rng.choice(n, size=k, replace=False)
        lo = self.at
        hi = avail.shape[0] if self.permanent else min(self.at + self.span,
                                                       avail.shape[0])
        if lo < avail.shape[0]:
            avail[lo:hi, down] = 0.0
        self._avail = avail

    def availability(self):
        return self._avail


class HostPreempt(WorldTransform):
    """Scheduled preemption of the DRIVER process at round ``at`` (and
    every ``every`` rounds after, when ``every > 0``).  Pure host-level
    metadata surfaced as ``ScenarioWorld.preempt_rounds`` — harnesses use
    it to SIGKILL the process mid-run and then exercise snapshot resume;
    the device program is unaffected."""

    name = "host_preempt"

    def __init__(self, at: int = 32, every: int = 0):
        if at < 1:
            raise ValueError(f"host_preempt at must be >= 1 (got {at})")
        if every < 0:
            raise ValueError(f"host_preempt every must be >= 0 (got {every})")
        self.at = int(at)
        self.every = int(every)

    def prepare(self, n, rounds, rng):
        rounds = max(rounds, 1)
        pts = [self.at]
        if self.every > 0:
            nxt = self.at + self.every
            while nxt < rounds:
                pts.append(nxt)
                nxt += self.every
        self._rounds = np.asarray([p for p in pts if p < rounds],
                                  dtype=np.int64)

    def preempt_rounds(self):
        return self._rounds


class SlotPoison(WorldTransform):
    """Deterministic serve-lane poisoning: request ``rid``'s decode
    logits go NaN at decode step ``step`` (and every ``every`` steps
    after, when ``every > 0``) — IF the request occupies a slot then.
    The device quarantines the lane in-mask; with retries enabled the
    host re-admits with backoff, so this transform is the unit driver of
    the whole recovery path.  A request poisoned at ``every=1`` fails on
    every attempt — the retry-exhaustion worst case."""

    name = "slot_poison"

    def __init__(self, rid: int = 0, step: int = 1, every: int = 0):
        if rid < 0:
            raise ValueError(f"slot_poison rid must be >= 0 (got {rid})")
        if step < 0:
            raise ValueError(f"slot_poison step must be >= 0 (got {step})")
        if every < 0:
            raise ValueError(f"slot_poison every must be >= 0 (got {every})")
        self.rid = int(rid)
        self.step = int(step)
        self.every = int(every)

    def prepare(self, n, rounds, rng):
        horizon = max(rounds, self.step + 1)
        rid = min(self.rid, max(n - 1, 0))    # clamp to the request set
        steps = ([self.step] if self.every == 0
                 else list(range(self.step, horizon, self.every)))
        self._cells = np.array([(rid, s) for s in steps], dtype=np.int64)

    def serve_poisons(self):
        return self._cells


class ServePreempt(WorldTransform):
    """Scheduled preemption of the SERVE driver at decode-step boundary
    ``at`` (and every ``every`` steps after, when ``every > 0``) — the
    decode-clock sibling of :class:`HostPreempt`.  Pure host metadata:
    the slot server force-offers a snapshot and raises
    ``ServePreempted`` at the first chunk boundary past each point;
    harnesses catch it and resume from the snapshot directory."""

    name = "serve_preempt"

    def __init__(self, at: int = 8, every: int = 0):
        if at < 1:
            raise ValueError(f"serve_preempt at must be >= 1 (got {at})")
        if every < 0:
            raise ValueError(
                f"serve_preempt every must be >= 0 (got {every})")
        self.at = int(at)
        self.every = int(every)

    def prepare(self, n, rounds, rng):
        horizon = max(rounds, 1)
        pts = [self.at]
        if self.every > 0:
            nxt = self.at + self.every
            while nxt < horizon:
                pts.append(nxt)
                nxt += self.every
        self._steps = np.asarray([p for p in pts if p < horizon],
                                 dtype=np.int64)

    def serve_preempt_steps(self):
        return self._steps


@dataclasses.dataclass(frozen=True)
class ServeFaults:
    """Realised serve-fault plan on the decode-step clock.

    ``poisons`` is a tuple of (rid, decode-step) cells (absolute steps);
    ``preempt_steps`` the driver-kill boundaries.  Plain data — the slot
    server consumes it structurally, keeping ``repro.distributed`` free
    of a ``repro.faults`` import."""

    poisons: tuple = ()
    preempt_steps: tuple = ()

    @property
    def empty(self) -> bool:
        return not self.poisons and not self.preempt_steps


def realise_serve_faults(spec, n_requests: int, horizon: int,
                         seed: int = 0) -> ServeFaults:
    """Lower a scenario spec (string or parsed ``Scenario``) to the
    serve-fault channels, with the standard per-(seed, position)
    realisation RNGs.  Transforms without serve channels contribute
    nothing — a training-fault spec realises as an empty bundle."""
    from ..scenarios.scenario import parse_scenario

    scen = parse_scenario(spec) if isinstance(spec, str) else spec
    poisons, preempts = set(), set()
    for i, tr in enumerate(scen.transforms):
        tr.prepare(int(n_requests), int(horizon),
                   np.random.default_rng([seed, i]))
        cells = tr.serve_poisons()
        if cells is not None:
            poisons.update((int(r), int(s)) for r, s in np.asarray(cells))
        steps = tr.serve_preempt_steps()
        if steps is not None:
            preempts.update(int(s) for s in np.asarray(steps))
    return ServeFaults(poisons=tuple(sorted(poisons)),
                       preempt_steps=tuple(sorted(preempts)))


FAULT_TRANSFORMS = {
    cls.name: cls
    for cls in (NanGrad, CorruptReceipt, WorkerCrash, HostPreempt,
                SlotPoison, ServePreempt)
}

# register into the shared grammar vocabulary (dict mutated in place, so
# every module holding a reference to TRANSFORMS sees the fault names)
TRANSFORMS.update(FAULT_TRANSFORMS)
