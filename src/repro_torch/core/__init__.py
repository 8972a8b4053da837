"""AsGrad core, framework-free: the schedule engine and its registries.

Counterpart of ``repro/core``.  ``types``, ``delays``, ``schedulers`` and
``engine`` are verbatim numpy copies of the JAX package's modules, so the
port realises the same orderings (i_t, π_t) bit for bit; ``trace`` carries
only ``summarize``.  The simulator and the theory estimators import jax
there and are a later slice of the port.
"""
from .delays import TimingModel, PATTERNS, heterogeneous_speeds
from .schedulers import (
    Scheduler,
    PureAsync,
    PureAsyncWaiting,
    RandomAsync,
    RandomAsyncWaiting,
    ShuffledAsync,
    MiniBatch,
    RandomReshuffling,
    make_scheduler,
    REGISTRY,
)
from .engine import (Schedule, build_schedule, lower_rounds, round_masks,
                     round_delay_scales)
from . import trace

__all__ = [
    "TimingModel", "PATTERNS", "heterogeneous_speeds",
    "Scheduler", "PureAsync", "PureAsyncWaiting", "RandomAsync",
    "RandomAsyncWaiting", "ShuffledAsync", "MiniBatch", "RandomReshuffling",
    "make_scheduler", "REGISTRY",
    "Schedule", "build_schedule", "lower_rounds", "round_masks",
    "round_delay_scales",
    "trace",
]
