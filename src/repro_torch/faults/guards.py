"""Guard-rail configuration and the host-side divergence circuit-breaker.

Two layers of defence against faulty updates, justified by the
delay-robust analyses this repo reproduces (Koloskova et al.,
arXiv:2206.08307 — convergence survives *dropping* bad or stale
updates):

* :class:`GuardConfig` parameterises the DEVICE-side rails compiled into
  ``AsyncTrainer.step`` (no host readback, mask-style inside the scan
  body): a per-round non-finite check on the loss and the raw gradient
  norm that skips the whole apply when it fails, plus a per-worker
  health channel that backs the effective stepsize off after a bad
  receipt and recovers it multiplicatively on clean ones.

* :class:`DivergenceBreaker` is the HOST-side circuit-breaker: it
  watches the per-round loss rows streaming through the executor's tap
  lane and trips when a recent window diverges from the best window seen
  so far — the executor then stops launching further chunks
  (already-enqueued chunks drain; nothing blocks the device).

This module deliberately imports neither JAX nor any repro subpackage,
so both the trainer and the executor can depend on it without cycles.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Device-side guard rails for ``AsyncTrainer.step``.

    A round is *bad* for the workers that participated in it when the
    loss or the raw (pre-clip, pre-sparsify-aware) gradient norm is
    non-finite, or — with ``spike_norm`` set — when the raw norm exceeds
    that threshold.  Non-finite rounds skip the apply entirely: the
    gradients are zeroed before they can reach the optimizer moments or
    the delay buffer, and every state leaf except the step counter and
    the guard health keeps its previous value.  Spiky-but-finite rounds
    still apply (clipping already bounds them) but charge the
    participants' health.

    Health h_i ∈ [min_scale, 1] per worker: participants of a bad round
    take ``h_i *= backoff``; participants of a clean round recover
    ``h_i = min(1, h_i * recover)``.  The round's update is scaled by
    the participation-weighted mean health, so a worker that keeps
    sending garbage fades toward ``min_scale`` influence instead of
    poisoning γ for everyone.
    """

    backoff: float = 0.5
    recover: float = 1.25
    min_scale: float = 0.1
    #: raw grad-norm threshold counting as a (finite) fault for health
    #: purposes; None disables the spike check
    spike_norm: Optional[float] = None

    def __post_init__(self):
        if not 0.0 < self.backoff < 1.0:
            raise ValueError(f"backoff must be in (0, 1) (got {self.backoff})")
        if self.recover < 1.0:
            raise ValueError(f"recover must be >= 1 (got {self.recover})")
        if not 0.0 < self.min_scale <= 1.0:
            raise ValueError(
                f"min_scale must be in (0, 1] (got {self.min_scale})")
        if self.spike_norm is not None and self.spike_norm <= 0:
            raise ValueError(
                f"spike_norm must be positive (got {self.spike_norm})")


class DivergenceBreaker:
    """Windowed divergence circuit-breaker fed from the tap lane.

    Maintains a sliding window of the last ``window`` *finite* losses
    and the best — lowest — window mean seen so far.  Once at least one
    full window has been observed, a current window mean exceeding
    ``factor × best`` trips the breaker; the first observed round at or
    past the trip is recorded in :attr:`tripped_round`.

    A NON-FINITE loss trips immediately: NaN compares false against
    ``factor × best``, so folding it into the window would leave a
    NaN-only divergence undetected forever.  (The device-side skip guard
    still drops the round's update; the breaker's job is to stop
    LAUNCHING — a run whose loss went NaN has nothing left to compute.)

    ``observe`` is called from the executor's ordered tap callback, so
    rounds arrive in order; the executor polls :attr:`tripped` before
    launching each chunk and stops the launch loop once tripped —
    chunks already on the device stream drain normally (barrier-free).
    """

    def __init__(self, window: int = 8, factor: float = 10.0):
        if window < 1:
            raise ValueError(f"window must be >= 1 (got {window})")
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1 (got {factor})")
        self.window = int(window)
        self.factor = float(factor)
        self.tripped_round: Optional[int] = None
        self._recent: deque = deque(maxlen=self.window)
        self._best: Optional[float] = None

    @property
    def tripped(self) -> bool:
        return self.tripped_round is not None

    def observe(self, round_idx: int, loss: float) -> bool:
        """Feed one per-round loss; returns True when (already) tripped."""
        if self.tripped:
            return True
        loss = float(loss)
        if loss != loss or loss in (float("inf"), float("-inf")):
            # NaN/inf never exceeds factor×best by comparison — trip NOW
            self.tripped_round = int(round_idx)
            return True
        self._recent.append(loss)
        if len(self._recent) < self.window:
            return False
        mean = sum(self._recent) / self.window
        if self._best is not None and mean > self.factor * self._best:
            self.tripped_round = int(round_idx)
            return True
        self._best = mean if self._best is None else min(self._best, mean)
        return False
