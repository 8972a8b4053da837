"""Schedule → plan → rounds on the device (see ``plan`` and ``executor``)."""
from .plan import (RunPlan, compile_plan, quantize_zipf_trajectory,
                   round_keys)
from .executor import (METRICS, METRIC_MODES, ExecResult, ExecStats,
                       PlanExecutor, execute, make_batch_fn, run_eager,
                       run_grid, run_scan)

__all__ = ["RunPlan", "compile_plan", "quantize_zipf_trajectory",
           "round_keys", "METRICS",
           "METRIC_MODES", "ExecResult", "ExecStats", "PlanExecutor",
           "execute", "make_batch_fn", "run_eager", "run_grid",
           "run_scan"]
