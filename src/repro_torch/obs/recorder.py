"""The :class:`Recorder` handle threaded through the runtime.

Counterpart of ``repro/obs/recorder.py``, copied: the module is
framework-free.

One ``Recorder`` per run is what the instrumented components accept
(``PlanExecutor``, ``SlotServer``, ``AsyncSnapshotter``,
the backends): it owns a :class:`~repro_torch.obs.tracer.Tracer`,
delegates the span/instant/metric primitives to it, and adds the
end-of-run :meth:`summary` dict that rides ``RunResult.extra["obs"]``
through serialization (plain scalars only — it must survive
``RunResult.to_json`` round-trips).

Every instrumented call site guards with ``if recorder is not None`` —
an un-observed run pays literally zero (no null-object dispatch on the
tap hot path).
"""
from __future__ import annotations

from .schema import METRICS_SCHEMA_VERSION
from .tracer import Tracer


class Recorder:
    """Per-run observability handle: a Tracer plus summary assembly."""

    def __init__(self, tracer: Tracer = None):
        self.tracer = tracer if tracer is not None else Tracer()

    # -------------------------------------------------- tracer delegation
    def span(self, name, lane="main", **args):
        return self.tracer.span(name, lane, **args)

    def span_at(self, name, lane, start_ns, end_ns, **args):
        self.tracer.span_at(name, lane, start_ns, end_ns, **args)

    def instant(self, name, lane="main", **args):
        self.tracer.instant(name, lane, **args)

    def count(self, name, inc=1):
        self.tracer.count(name, inc)

    def gauge(self, name, value, lane="main"):
        self.tracer.gauge(name, value, lane)

    def hist(self, name, value):
        self.tracer.hist(name, value)

    def now_ns(self):
        return self.tracer.now_ns()

    def export_chrome(self, path: str) -> str:
        return self.tracer.export_chrome(path)

    def export_metrics(self, path: str) -> str:
        return self.tracer.export_metrics(path)

    # ----------------------------------------------------------- summary
    def summary(self, **extra) -> dict:
        """The machine-readable run summary (``RunResult.extra["obs"]``).

        ``phases`` is the span time-in-phase table, ``counters`` the
        final cumulative counts, ``hists`` the histogram summaries —
        everything :func:`repro_torch.obs.render_summary` needs to print the
        human table.  ``extra`` keys (e.g. ``rounds``,
        ``tau_max``) merge in at the top level.
        """
        out = {
            "schema_version": METRICS_SCHEMA_VERSION,
            "wall_s": round(self.tracer.wall_s, 6),
            "phases": self.tracer.phase_table(),
            "counters": self.tracer.counters(),
            "hists": self.tracer.hist_summaries(),
        }
        out.update(extra)
        return out
