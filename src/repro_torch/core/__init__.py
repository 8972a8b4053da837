"""AsGrad core: the schedule engine, its registries and the exact replay.

Counterpart of ``repro/core``.  ``types``, ``delays``, ``schedulers``,
``engine`` and ``theory`` are verbatim copies of the JAX package's modules
(numpy and ``math``), so the port realises the same orderings (i_t, π_t)
bit for bit; ``simulator`` is the exact replay on a torch device (CUDA
graph chunks on the card) and ``trace`` the theory estimators over it.
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
from .simulator import (replay, replay_grid, run_async_sgd,
                        delay_adaptive_stepsizes, ReplayResult)
from . import theory, trace

__all__ = [
    "TimingModel", "PATTERNS", "heterogeneous_speeds",
    "Scheduler", "PureAsync", "PureAsyncWaiting", "RandomAsync",
    "RandomAsyncWaiting", "ShuffledAsync", "MiniBatch", "RandomReshuffling",
    "make_scheduler", "REGISTRY",
    "Schedule", "build_schedule", "lower_rounds", "round_masks",
    "round_delay_scales",
    "replay", "replay_grid", "run_async_sgd", "delay_adaptive_stepsizes",
    "ReplayResult",
    "theory", "trace",
]
