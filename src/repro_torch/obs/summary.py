"""Human rendering of a :meth:`repro_torch.obs.Recorder.summary` dict.

Counterpart of ``repro/obs/summary.py``, copied: the module is
framework-free."""
from __future__ import annotations

from typing import Optional


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render_summary(summary: dict, trace: Optional[dict] = None,
                   title: str = "observability summary") -> str:
    """ASCII table of a run's obs summary: time-in-phase breakdown,
    dispatch counters, histogram summaries, and (when ``trace`` — the
    ``RunResult.trace`` τ-statistics dict — is given) the delay stats
    AsGrad's rates are written in.  Works equally on a live
    ``recorder.summary()`` and on ``extra["obs"]`` restored from an
    archived ``RunResult`` JSON.
    """
    wall = float(summary.get("wall_s", 0.0))
    lines = [title, "=" * len(title)]

    phases = summary.get("phases") or {}
    if phases:
        lines.append(f"{'phase':<22} {'count':>7} {'total_s':>9} "
                     f"{'mean_ms':>9} {'% wall':>7}")
        for name, e in sorted(phases.items(),
                              key=lambda kv: -kv[1]["total_s"]):
            pct = 100.0 * e["total_s"] / wall if wall > 0 else 0.0
            lines.append(f"{name:<22} {e['count']:>7} {e['total_s']:>9.4f} "
                         f"{e['mean_ms']:>9.3f} {pct:>6.1f}%")
    else:
        lines.append("(no spans recorded)")

    counters = summary.get("counters") or {}
    if counters:
        lines.append("")
        lines.append("counters: " + "  ".join(
            f"{k}={_fmt(v)}" for k, v in sorted(counters.items())))
    rounds = counters.get("rounds") or summary.get("rounds")
    if rounds and wall > 0:
        lines.append(f"throughput: {float(rounds) / wall:.2f} rounds/s "
                     f"over {wall:.3f}s")

    hists = summary.get("hists") or {}
    if hists:
        lines.append("")
        lines.append(f"{'histogram':<22} {'count':>7} {'p50':>9} "
                     f"{'p95':>9} {'max':>9}")
        for name, h in sorted(hists.items()):
            lines.append(f"{name:<22} {h['count']:>7} "
                         f"{_fmt(h['p50']):>9} {_fmt(h['p95']):>9} "
                         f"{_fmt(h['max']):>9}")

    if trace:
        keys = ("tau_max", "tau_avg", "tau_c", "wait_b", "T")
        stats = "  ".join(f"{k}={_fmt(trace[k])}" for k in keys
                          if k in trace)
        if stats:
            lines.append("")
            lines.append("schedule: " + stats)
    return "\n".join(lines)
