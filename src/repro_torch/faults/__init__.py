"""repro.faults — deterministic fault injection and guard rails.

Three pieces, one per execution tier:

* :mod:`transforms` — scheduled fault transforms (``nan_grad``,
  ``corrupt_receipt``, ``worker_crash``, ``host_preempt``) lowering into
  ``RunPlan`` channels through the ordinary scenario grammar, so
  injected faults replay bit-for-bit under scan ≡ eager.
* :class:`GuardConfig` — device-side non-finite skip guard and
  per-worker health backoff compiled into ``AsyncTrainer.step``.
* :class:`DivergenceBreaker` — host-side windowed circuit-breaker fed
  from the executor's tap lane.

Durability (the async tap-mode snapshotter) lives in
``repro.checkpoint.snapshot`` — faults make it necessary; the
checkpoint package owns the format.
"""
from .guards import DivergenceBreaker, GuardConfig
from .transforms import (
    FAULT_TRANSFORMS,
    CorruptReceipt,
    HostPreempt,
    NanGrad,
    ServeFaults,
    ServePreempt,
    SlotPoison,
    WorkerCrash,
    realise_serve_faults,
)

__all__ = [
    "GuardConfig",
    "DivergenceBreaker",
    "FAULT_TRANSFORMS",
    "NanGrad",
    "CorruptReceipt",
    "WorkerCrash",
    "HostPreempt",
    "SlotPoison",
    "ServePreempt",
    "ServeFaults",
    "realise_serve_faults",
]
