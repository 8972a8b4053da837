"""Schedule statistics (Defs 1–2 + balance) for ``RunResult.trace``.

Counterpart of ``repro/core/trace.py``; this module carries only
:func:`summarize`.  The gradient-based estimators of that module (ζ, σ², ν²)
need the simulator tier and are ported with it.
"""
from __future__ import annotations

from .engine import Schedule


def summarize(schedule: Schedule) -> dict:
    """One-line schedule summary (Defs 1–2 + balance)."""
    jpw = schedule.jobs_per_worker()
    return {
        "T": schedule.T,
        "tau_max": schedule.tau_max(),
        "tau_avg": round(schedule.tau_avg(), 3),
        "tau_c": schedule.tau_c(),
        "wait_b": schedule.wait_b,
        "jobs_min": int(jpw.min()),
        "jobs_max": int(jpw.max()),
        "jobs_std": round(float(jpw.std()), 3),
    }
