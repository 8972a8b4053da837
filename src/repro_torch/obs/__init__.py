"""``repro_torch.obs`` — tracing and metrics across the port's runtime.

Counterpart of ``repro.obs``; stdlib only.  A :class:`Tracer` collects
host-timestamped spans, instants and metrics at host boundaries that
exist anyway (never a new device sync, so on the card a span measures
host enqueue time); a per-run :class:`Recorder` handle is threaded
through ``PlanExecutor``, ``SlotServer``, ``AsyncSnapshotter`` and the
backends; :class:`CompileWatch` counts CUDA graph captures and raises on
a steady-state recapture; exports are Chrome trace events (Perfetto) and
a schema-versioned JSONL metrics log, with their validators, and
:func:`render_summary` prints the time-in-phase table.

    from repro_torch.obs import Recorder, render_summary

    rec = Recorder()
    res = TrainerBackend(device="cpu", recorder=rec).run(spec)
    rec.export_chrome("trace.json")      # -> ui.perfetto.dev
    rec.export_metrics("metrics.jsonl")  # -> schema-validated log
    print(render_summary(res.extra["obs"], trace=res.trace))
"""
from .compile_watch import CompileWatch, RetraceError
from .recorder import Recorder
from .schema import (METRICS_SCHEMA_VERSION, SchemaError,
                     validate_chrome_trace, validate_line, validate_lines,
                     validate_metrics_log)
from .summary import render_summary
from .tracer import Tracer

__all__ = [
    "CompileWatch", "RetraceError", "Recorder", "Tracer",
    "METRICS_SCHEMA_VERSION", "SchemaError", "validate_chrome_trace",
    "validate_line", "validate_lines", "validate_metrics_log",
    "render_summary",
]
