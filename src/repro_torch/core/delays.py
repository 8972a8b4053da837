"""Worker timing models — Section 5 / Appendix A of the paper.

Each worker ``i`` owns a positive speed parameter ``s_i``; a timing model
turns it into a per-job compute time ``r`` (in simulated seconds):

* ``fixed``:    r = s_i                       (fixed delay pattern)
* ``poisson``:  r ~ Po(s_i)                   (clamped to >= 1)
* ``normal``:   r = |N(mean s_i, variance s_i)| + 1
                (i.e. std = sqrt(s_i); mean and variance both equal s_i,
                matching the Poisson pattern's first two moments)
* ``uniform``:  r ~ Uni(0, s_i)
* ``bursty``:   r = 4·s_i w.p. 1/4, else ~0 — same mean s_i as the
                others, but draws cluster: runs of near-zero gaps
                (geometric, mean length 4) separated by 4·s_i lulls.
                As an ARRIVAL pattern (``draw_arrivals``) this yields
                burst traffic — batches of simultaneous requests — the
                overload-shedding worst case.

The first four are exactly the patterns the paper benchmarks; ``bursty``
is the serving lane's addition.  The simulator is
agnostic: anything with ``sample(worker) -> float`` works.  Non-stationary
worlds (drifting speeds, stragglers, elastic pools) wrap these stationary
models — see :mod:`repro.scenarios`; the wrappers reuse :meth:`_draw` on a
modulated speed so an identity wrap consumes the RNG stream bit-for-bit
identically.
"""
from __future__ import annotations

import numpy as np

PATTERNS = ("fixed", "poisson", "normal", "uniform", "bursty")


class TimingModel:
    """Samples per-job compute times for ``n`` workers.

    Parameters
    ----------
    speeds:
        array of per-worker parameters ``s_i`` (larger = slower worker).
    pattern:
        one of :data:`PATTERNS`.
    seed:
        host RNG seed (timings are host-side; they order events, they do not
        enter any jax computation).
    """

    def __init__(self, speeds, pattern: str = "fixed", seed: int = 0):
        speeds = np.asarray(speeds, dtype=np.float64)
        if np.any(speeds <= 0):
            raise ValueError("worker speed parameters must be positive")
        if pattern not in PATTERNS:
            raise ValueError(f"unknown pattern {pattern!r}; want one of {PATTERNS}")
        self.speeds = speeds
        self.pattern = pattern
        self._rng = np.random.default_rng(seed)

    @property
    def n_workers(self) -> int:
        return int(self.speeds.shape[0])

    # ------------------------------------------------------------------ draws
    def _draw(self, s: float) -> float:
        """One compute-time draw at speed parameter ``s`` — the single
        place distribution semantics live (scalar oracle; wrappers feed a
        modulated ``s`` through the same RNG stream)."""
        if self.pattern == "fixed":
            r = s
        elif self.pattern == "poisson":
            r = float(self._rng.poisson(s))
            r = max(r, 1.0)
        elif self.pattern == "normal":
            # mean s, variance s (std = sqrt(s)) — see module docstring
            r = abs(float(self._rng.normal(s, np.sqrt(s)))) + 1.0
        elif self.pattern == "uniform":
            r = float(self._rng.uniform(0.0, s))
            r = max(r, 1e-6)
        else:  # bursty: one uniform decides lull (p=1/4) vs in-burst (~0)
            r = 4.0 * s if float(self._rng.random()) < 0.25 else 1e-6
        return r

    def _draw_batch(self, s: np.ndarray) -> np.ndarray:
        """Vectorised :meth:`_draw`: one RNG call for the whole batch.

        numpy ``Generator`` fills array requests element-by-element from
        the same bit stream as repeated scalar calls, so the batched draws
        are bit-identical to a ``[_draw(x) for x in s]`` loop — the scalar
        path stays the test oracle (tests/test_scenarios.py pins this)."""
        s = np.asarray(s, dtype=np.float64)
        if self.pattern == "fixed":
            return s.copy()
        if self.pattern == "poisson":
            return np.maximum(self._rng.poisson(s).astype(np.float64), 1.0)
        if self.pattern == "normal":
            return np.abs(self._rng.normal(s, np.sqrt(s))) + 1.0
        if self.pattern == "uniform":
            return np.maximum(self._rng.uniform(0.0, s), 1e-6)
        # bursty: Generator.random(shape) consumes the same doubles as the
        # scalar loop, so the batch stays bit-identical to the oracle
        u = self._rng.random(s.shape)
        return np.where(u < 0.25, 4.0 * s, 1e-6)

    # ------------------------------------------------------------- public API
    def sample(self, worker: int) -> float:
        return self._draw(float(self.speeds[worker]))

    def sample_round(self, workers) -> np.ndarray:
        """Batched per-job compute times for a round's worth of job starts.

        ``workers`` is a sequence of worker indices (duplicates allowed —
        a waiting round can start several jobs on distinct workers, and
        the engine batches all simultaneous starts into ONE RNG call).
        Returns ``(len(workers),)`` float64 draws, bit-identical to
        calling :meth:`sample` once per worker in order.
        """
        workers = np.asarray(workers, dtype=np.intp)
        if workers.size == 0:
            return np.zeros(0, dtype=np.float64)
        return self._draw_batch(self.speeds[workers])


def heterogeneous_speeds(n: int, slow_factor: float = 5.0, base: float = 1.0):
    """Linearly spread speeds in [base, base*slow_factor] — a simple
    heterogeneous-cluster profile used across benchmarks/examples."""
    return base * (1.0 + (slow_factor - 1.0) * np.arange(n) / max(n - 1, 1))
