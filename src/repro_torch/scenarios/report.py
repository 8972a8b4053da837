"""Rates report: realised τ-statistics per scenario window vs theory.

The paper's thesis is that convergence is governed by the REALISED delay
statistics (Definitions 1 & 2: τ_max, τ_avg; Definition of concurrency:
τ_C).  A non-stationary world makes those statistics time-varying, so the
report slices the realised schedule into receipt windows, recomputes the
statistics per window, and evaluates the matching Table-1 rate
(:mod:`repro.core.theory`) at the window's constants — showing exactly
when (e.g. inside a straggler window) the predicted bound degrades.

The GLOBAL row calls the Schedule's own ``tau_max/tau_avg/tau_c`` methods,
so for a stationary world the report reproduces the existing statistics
exactly — no parallel reimplementation to drift out of sync.  The
Koloskova sanity relations (τ_avg ≤ τ_C; τ_C ≤ scheduler concurrency) are
checked on the global row.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.engine import Schedule
from ..core.theory import RATES, ProblemConstants

#: unit-scale default constants; G=1 so bounded-gradient rates are defined
DEFAULT_CONSTANTS = ProblemConstants(L=1.0, F0=1.0, sigma2=1.0, zeta2=0.0,
                                     G=1.0)


def predicted_rate(policy: str, c: ProblemConstants, *, T: int, tau_c: int,
                   tau_max: int, b: int, n: int) -> float:
    """Evaluate the Table-1 rate for ``policy`` at the given schedule
    constants (dispatching each row's own signature)."""
    fn = RATES[policy]
    tau_c = max(int(tau_c), 1)
    tau_max = max(int(tau_max), 1)
    T = max(int(T), 1)
    if policy == "pure":
        return fn(c, T, tau_c, tau_max, bounded_grad=c.G > 0)
    if policy == "pure_waiting":
        return fn(c, T, tau_c, tau_max, b, bounded_grad=c.G > 0)
    if policy == "random":
        return fn(c, T, tau_c)
    if policy == "fedbuff":
        return fn(c, T, tau_c, b)
    if policy in ("shuffled", "rr"):
        return fn(c, T, n)
    if policy == "minibatch":
        return fn(c, T, b)
    raise KeyError(policy)


@dataclasses.dataclass(frozen=True)
class WindowStats:
    """Realised delay statistics over receipts t ∈ [lo, hi)."""

    lo: int
    hi: int
    tau_max: int
    tau_avg: float
    tau_c: int
    rate: float | None = None


def window_stats(schedule: Schedule, n_windows: int = 4) -> list:
    """Slice the schedule into ``n_windows`` equal receipt windows.

    Window statistics use the same quantities as the global methods
    (delays t − π_t; active jobs before each receipt) restricted to the
    window; unfinished-job corrections only apply to the final global
    statistics and are intentionally excluded here.
    """
    T = schedule.T
    n_windows = max(1, min(int(n_windows), T)) if T else 1
    edges = np.linspace(0, T, n_windows + 1).astype(int)
    out = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        if hi <= lo:
            continue
        d = schedule.delays[lo:hi]
        a = schedule.active_jobs[lo:hi]
        out.append(WindowStats(
            lo=int(lo), hi=int(hi),
            tau_max=int(d.max(initial=0)),
            tau_avg=float(d.mean()) if hi > lo else 0.0,
            tau_c=int(a.max(initial=0)),
        ))
    return out


def tau_report(schedule: Schedule, policy: str, *, n_windows: int = 4,
               constants: ProblemConstants | None = None,
               concurrency: int | None = None,
               scenario_spec: str = "",
               evictions: dict | None = None,
               timeouts: dict | None = None,
               shed: dict | None = None,
               drained: dict | None = None,
               attempts: dict | None = None) -> dict:
    """Full report dict: global stats + per-window stats, each with the
    matching Table-1 rate, plus the Koloskova sanity relations.

    ``evictions`` / ``timeouts`` / ``shed`` / ``drained`` are the serving
    lane's degradation maps (rid → decode step, from
    :class:`~repro.distributed.admission.AdmissionTrace`) and ``attempts``
    the retry ledger (rid → failed attempts consumed): passed through
    under ``"degraded"`` so the rendered report accounts every request the
    pool quarantined, timed out, shed, drained or retried — the
    no-silent-loss audit trail the chaos suite checks."""
    c = constants or DEFAULT_CONSTANTS
    b = schedule.wait_b
    n = schedule.n_workers
    g_tau_max = schedule.tau_max()
    g_tau_avg = schedule.tau_avg()
    g_tau_c = schedule.tau_c()
    windows = []
    for w in window_stats(schedule, n_windows):
        rate = predicted_rate(policy, c, T=w.hi - w.lo, tau_c=w.tau_c,
                              tau_max=w.tau_max, b=b, n=n)
        windows.append(dataclasses.replace(w, rate=rate))
    return {
        "policy": policy,
        "scenario": scenario_spec,
        "T": schedule.T,
        "wait_b": b,
        "n_workers": n,
        "global": {
            "tau_max": g_tau_max,
            "tau_avg": g_tau_avg,
            "tau_c": g_tau_c,
            "rate": predicted_rate(policy, c, T=schedule.T, tau_c=g_tau_c,
                                   tau_max=g_tau_max, b=b, n=n),
        },
        "windows": windows,
        "degraded": {
            "evictions": {int(k): int(v)
                          for k, v in (evictions or {}).items()},
            "timeouts": {int(k): int(v)
                         for k, v in (timeouts or {}).items()},
            "shed": {int(k): int(v) for k, v in (shed or {}).items()},
            "drained": {int(k): int(v)
                        for k, v in (drained or {}).items()},
            "attempts": {int(k): int(v)
                         for k, v in (attempts or {}).items()},
        },
        "koloskova": {
            # τ_avg ≤ τ_C always (Koloskova et al. 22, restated §3.1)
            "tau_avg_le_tau_c": bool(g_tau_avg <= g_tau_c + 1e-9),
            # τ_C ≤ policy concurrency when the policy bounds it
            "tau_c_le_concurrency": (
                None if concurrency is None else bool(g_tau_c <= concurrency)),
        },
    }


def render_report(report: dict) -> str:
    """Plain-text table for the CLI (`launch/train --tau-report`)."""
    lines = []
    head = f"τ-report · policy={report['policy']}"
    if report.get("scenario"):
        head += f" · scenario={report['scenario']!r}"
    head += (f" · T={report['T']} b={report['wait_b']}"
             f" n={report['n_workers']}")
    lines.append(head)
    lines.append(f"{'window':>16} {'tau_max':>8} {'tau_avg':>8} "
                 f"{'tau_c':>6} {'rate':>12}")
    g = report["global"]
    lines.append(f"{'global':>16} {g['tau_max']:>8d} {g['tau_avg']:>8.2f} "
                 f"{g['tau_c']:>6d} {g['rate']:>12.4g}")
    for w in report["windows"]:
        span = f"[{w.lo},{w.hi})"
        lines.append(f"{span:>16} {w.tau_max:>8d} {w.tau_avg:>8.2f} "
                     f"{w.tau_c:>6d} {w.rate:>12.4g}")
    deg = report.get("degraded") or {}
    ev, to = deg.get("evictions") or {}, deg.get("timeouts") or {}
    sh, dr = deg.get("shed") or {}, deg.get("drained") or {}
    at = deg.get("attempts") or {}
    if ev or to or sh or dr or at:
        line = (f"degraded: {len(ev)} evicted "
                f"(quarantine) · {len(to)} timed out")
        if sh or dr:
            line += f" · {len(sh)} shed · {len(dr)} drained"
        if at:
            line += (f" · {len(at)} retried "
                     f"({sum(at.values())} failed attempts)")
        lines.append(line)
    k = report["koloskova"]
    checks = [f"tau_avg<=tau_c: {'ok' if k['tau_avg_le_tau_c'] else 'VIOLATED'}"]
    if k["tau_c_le_concurrency"] is not None:
        checks.append("tau_c<=concurrency: "
                      + ("ok" if k["tau_c_le_concurrency"] else "VIOLATED"))
    lines.append("  ".join(checks))
    return "\n".join(lines)
