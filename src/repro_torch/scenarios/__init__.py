"""repro.scenarios — composable non-stationary worlds for async SGD.

The scenario layer wraps any (Scheduler, TimingModel) pair from the core
registries in round-indexed world transforms (speed drift, stragglers,
elastic membership, data drift, gradient sparsification) and realises the
result with the UNMODIFIED discrete-event engine, yielding an ordinary
``Schedule`` plus per-round side channels that ``runtime.compile_plan``
folds into the device-resident ``RunPlan``.  See ``scenario.py`` for the
spec-string grammar and the bit-exactness contract (identity scenario ≡
stationary world, bit-for-bit).
"""
from .transforms import (
    TRANSFORMS,
    DataDrift,
    ElasticWorkers,
    Identity,
    SparsifiedGrads,
    SpeedDrift,
    Straggler,
    WorldTransform,
)
from .scenario import (
    Scenario,
    ScenarioScheduler,
    ScenarioTimingModel,
    ScenarioWorld,
    WorldClock,
    parse_scenario,
    realise_world,
)
from .report import (
    DEFAULT_CONSTANTS,
    WindowStats,
    predicted_rate,
    render_report,
    tau_report,
    window_stats,
)

# importing repro.faults registers the fault transforms (nan_grad,
# corrupt_receipt, worker_crash, host_preempt) into TRANSFORMS, so every
# spec-string consumer knows the fault grammar without extra imports
from .. import faults as _faults  # noqa: E402,F401  (registration side effect)

__all__ = [
    "TRANSFORMS",
    "WorldTransform",
    "Identity",
    "SpeedDrift",
    "Straggler",
    "ElasticWorkers",
    "DataDrift",
    "SparsifiedGrads",
    "Scenario",
    "parse_scenario",
    "ScenarioWorld",
    "ScenarioScheduler",
    "ScenarioTimingModel",
    "WorldClock",
    "realise_world",
    "WindowStats",
    "window_stats",
    "tau_report",
    "predicted_rate",
    "render_report",
    "DEFAULT_CONSTANTS",
]
