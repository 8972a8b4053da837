"""Composable world transforms — the vocabulary of non-stationary worlds.

A :class:`WorldTransform` modulates ONE aspect of a stationary
(scheduler × timing) world, keyed on the server ROUND index (the natural
clock of Algorithm 1: one aggregated update per ``wait_b`` receipts):

* timing-side (``modulates_speed``) — a multiplicative factor on the
  per-worker speed parameter ``s_i`` at the round a job *starts*
  (:class:`SpeedDrift`, :class:`Straggler`),
* membership-side — a per-round 0/1 availability table consumed both by
  the scheduler wrapper (no new jobs for down workers) and by the plan
  lowering (mask rows of down workers zeroed — the hard-drop channel)
  (:class:`ElasticWorkers`),
* data-side — a per-round Zipf exponent trajectory fed into the
  ``repro.data`` group distributions (:class:`DataDrift`),
* update-side — a per-round gradient keep-density in (0, 1] applied as
  magnitude top-k sparsification before the server update, the staleness
  remedy of Candela et al. (arXiv:1910.09466)
  (:class:`SparsifiedGrads`).

Every transform is deterministic given the realisation seed: `prepare`
receives a dedicated ``np.random.Generator`` (seeded per (scenario seed,
transform position)), precomputes its whole trajectory for the run, and the
query methods are pure table lookups.  An :class:`Identity` transform (and
any transform at neutral parameters) leaves the wrapped world bit-for-bit
identical to the unwrapped one.
"""
from __future__ import annotations

import numpy as np


class WorldTransform:
    """Base transform: neutral in every channel."""

    name = "base"
    #: True when the transform modulates per-worker compute speeds (the
    #: timing wrapper only consults these — cheap per-sample path)
    modulates_speed = False

    def prepare(self, n: int, rounds: int, rng: np.random.Generator) -> None:
        """Precompute trajectories for a run of ``rounds`` server rounds
        over ``n`` workers.  Called once per realisation."""

    # ---- timing channel ----------------------------------------------------
    def speed_factors(self, workers: np.ndarray, round_idx: int) -> np.ndarray:
        """(len(workers),) multiplicative factors on s_i at ``round_idx``
        (larger s = slower worker, so a factor > 1 is a slowdown)."""
        return np.ones(len(workers), dtype=np.float64)

    # ---- membership channel ------------------------------------------------
    def availability(self) -> np.ndarray | None:
        """(rounds, n) 0/1 table, or None when the transform never drops
        anyone."""
        return None

    # ---- data channel ------------------------------------------------------
    def zipf_trajectory(self) -> np.ndarray | None:
        """(rounds,) Zipf exponents, or None when the data law is static."""
        return None

    # ---- update channel ----------------------------------------------------
    def grad_density(self, schedule) -> np.ndarray | None:
        """(rounds,) keep-densities in (0, 1], or None.  Receives the
        REALISED schedule so densities can key on actual delays."""
        return None

    # ---- fault channels (repro.faults.transforms) --------------------------
    def fault_gain(self) -> np.ndarray | None:
        """(rounds, n) multiplicative gains on per-worker loss weights
        (NaN = poisoned receipt), or None when the transform injects no
        gradient faults."""
        return None

    def preempt_rounds(self) -> np.ndarray | None:
        """(k,) round indices at which the DRIVER process is scheduled to
        be preempted (host-level metadata, never lowered to device), or
        None."""
        return None

    # ---- serving channels (repro.faults.transforms) ------------------------
    # For serve-lane transforms ``prepare(n, rounds, rng)`` receives
    # n = n_requests and rounds = the decode-step horizon: the serving
    # clock is decode steps, not server rounds.
    def serve_poisons(self) -> np.ndarray | None:
        """(m, 2) int (rid, decode-step) cells whose decode logits the
        slot server poisons to NaN (driving the quarantine path), or None
        when the transform injects no serve faults."""
        return None

    def serve_preempt_steps(self) -> np.ndarray | None:
        """(k,) decode-step boundaries at which the SERVE driver process
        is scheduled to be preempted (host-level metadata; the chaos
        harness kills/raises there and exercises snapshot resume), or
        None."""
        return None


class Identity(WorldTransform):
    """Explicit no-op — a wrapped world with only Identity transforms must
    reproduce the stationary world bit-for-bit (the acceptance gate for
    the whole scenario layer)."""

    name = "identity"


def _windows(rounds: int, every: int, span: int):
    """Recurring windows [j·every, j·every + span), j >= 1 — round 0 stays
    clean so every world starts from the stationary regime."""
    j = 1
    while j * every < rounds:
        lo = j * every
        yield lo, min(lo + span, rounds)
        j += 1


class SpeedDrift(WorldTransform):
    """Smooth per-worker speed trajectories:
    s_i(q) = s_i · (1 + amp·sin(2π(q/period + i/n))).

    Workers drift out of phase (phase offset i/n), so the *relative* speed
    ordering — what the realised delays depend on — keeps rotating: the
    slowest worker of round 0 is mid-pack half a period later.
    """

    name = "drift"
    modulates_speed = True

    def __init__(self, period: float = 64.0, amp: float = 0.5):
        if not 0.0 <= amp < 1.0:
            raise ValueError(f"drift amp must be in [0, 1) (got {amp})")
        if period <= 0:
            raise ValueError(f"drift period must be positive (got {period})")
        self.period = float(period)
        self.amp = float(amp)

    def prepare(self, n, rounds, rng):
        q = np.arange(rounds + 1, dtype=np.float64)[:, None]
        phase = np.arange(n, dtype=np.float64)[None, :] / max(n, 1)
        self._table = 1.0 + self.amp * np.sin(
            2.0 * np.pi * (q / self.period + phase))

    def speed_factors(self, workers, round_idx):
        r = min(round_idx, self._table.shape[0] - 1)
        return self._table[r, workers]


class Straggler(WorldTransform):
    """Transient correlated slowdowns: every ``every`` rounds, ``k``
    workers (chosen per window from the realisation RNG) run ``factor``×
    slower for ``span`` rounds — the "one rack is thermally throttling"
    regime where τ_max decouples from τ_C."""

    name = "straggler"
    modulates_speed = True

    def __init__(self, k: int = 1, factor: float = 8.0, every: int = 16,
                 span: int = 4):
        if k < 1 or every < 1 or span < 1:
            raise ValueError("straggler k/every/span must be >= 1")
        if factor <= 0:
            raise ValueError(f"straggler factor must be positive (got {factor})")
        self.k = int(k)
        self.factor = float(factor)
        self.every = int(every)
        self.span = int(span)

    def prepare(self, n, rounds, rng):
        table = np.ones((rounds + 1, n), dtype=np.float64)
        k = min(self.k, n)
        for lo, hi in _windows(rounds + 1, self.every, self.span):
            hit = rng.choice(n, size=k, replace=False)
            table[lo:hi, hit] *= self.factor
        self._table = table

    def speed_factors(self, workers, round_idx):
        r = min(round_idx, self._table.shape[0] - 1)
        return self._table[r, workers]


class ElasticWorkers(WorldTransform):
    """Dropout/rejoin: every ``every`` rounds, ``k`` workers leave the pool
    for ``span`` rounds, then rejoin — n changes mid-run (the genuine
    extension beyond the paper).  Down workers receive no new jobs (the
    scheduler wrapper remaps their assignments onto available workers) and
    their residual in-flight receipts are hard-dropped on the compiled
    path (mask row zeroed via the plan's availability channel)."""

    name = "elastic"

    def __init__(self, k: int = 1, every: int = 16, span: int = 4):
        if k < 1 or every < 1 or span < 1:
            raise ValueError("elastic k/every/span must be >= 1")
        self.k = int(k)
        self.every = int(every)
        self.span = int(span)

    def prepare(self, n, rounds, rng):
        avail = np.ones((max(rounds, 1), n), dtype=np.float32)
        k = min(self.k, max(n - 1, 1))      # never drop the whole pool
        for lo, hi in _windows(max(rounds, 1), self.every, self.span):
            down = rng.choice(n, size=k, replace=False)
            avail[lo:hi, down] = 0.0
        self._avail = avail

    def availability(self):
        return self._avail


class DataDrift(WorldTransform):
    """Non-stationary data: the Zipf exponent of the group token
    distributions follows a trajectory — a linear ramp a0 → a1 over the
    run, or (with ``period``) a sinusoid oscillating between them.  The
    trajectory is quantised into a small CDF bank at plan-lowering time,
    so the compiled executor pays one extra gather per round."""

    name = "data_drift"

    def __init__(self, a0: float = 1.2, a1: float = 2.0,
                 period: float = 0.0):
        if a0 <= 0 or a1 <= 0:
            raise ValueError("data_drift exponents must be positive")
        self.a0 = float(a0)
        self.a1 = float(a1)
        self.period = float(period)

    def prepare(self, n, rounds, rng):
        q = np.arange(max(rounds, 1), dtype=np.float64)
        if self.period > 0:
            ramp = 0.5 * (1.0 - np.cos(2.0 * np.pi * q / self.period))
        else:
            ramp = q / max(rounds - 1, 1)
        self._traj = self.a0 + (self.a1 - self.a0) * ramp

    def zipf_trajectory(self):
        return self._traj


class SparsifiedGrads(WorldTransform):
    """Top-k gradient sparsification as a staleness remedy (Candela et
    al., arXiv:1910.09466): per round, only the largest-magnitude
    ``density`` fraction of each gradient leaf survives into the server
    update.  ``adaptive=1`` keys the density on the realised per-round
    mean delay — sparsify harder when staler,
    density_q = clip(1/(1+τ̄_q), frac, 1) — which is the remedy coupling
    the paper's τ-statistics make measurable."""

    name = "sparsify"

    def __init__(self, frac: float = 0.5, adaptive: int = 0):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"sparsify frac must be in (0, 1] (got {frac})")
        self.frac = float(frac)
        self.adaptive = bool(adaptive)

    def prepare(self, n, rounds, rng):
        self._rounds = max(rounds, 1)

    def grad_density(self, schedule):
        rounds = self._rounds
        if not self.adaptive:
            return np.full(rounds, self.frac, dtype=np.float32)
        b = schedule.wait_b
        n_full = min(rounds, schedule.T // b)
        d = schedule.delays[:n_full * b].astype(np.float64)
        tau = np.zeros(rounds, dtype=np.float64)
        tau[:n_full] = d.reshape(n_full, b).mean(axis=1)
        return np.clip(1.0 / (1.0 + tau), self.frac, 1.0).astype(np.float32)


#: spec-string name → transform class (the grammar's vocabulary)
TRANSFORMS = {
    cls.name: cls
    for cls in (Identity, SpeedDrift, Straggler, ElasticWorkers, DataDrift,
                SparsifiedGrads)
}
