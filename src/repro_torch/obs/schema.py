"""Versioned schema of the JSONL metrics log and the Chrome trace (and
their validators).

Counterpart of ``repro/obs/schema.py``, copied (the module is
framework-free), plus :func:`validate_chrome_trace` for the trace export.

Every line of a ``Tracer.export_metrics`` log is a standalone JSON
object tagged ``"v": METRICS_SCHEMA_VERSION`` — consumers (the CI
schema gate, the future self-tuning cache) validate per line and can
skip kinds they predate.  Line kinds:

* ``header`` — exactly one, first: ``{"v", "kind", "source",
  "wall_s", "created_unix"}``.
* ``gauge`` — a timestamped point sample: ``{"v", "kind", "t_us",
  "lane", "name", "value"}`` (``t_us``: microseconds on the tracer's
  monotonic clock).
* ``counter`` — a final cumulative value: ``{"v", "kind", "name",
  "value"}``.
* ``hist`` — a histogram summary: ``{"v", "kind", "name", "count",
  "min", "max", "mean", "p50", "p95"}``.

The validator is hand-rolled (this package is zero-dependency by
contract — no jsonschema): required keys, types, and the
header-first/header-once structural rules.  Run it as a module to gate
a file in CI::

    python -m repro_torch.obs.schema metrics.jsonl
"""
from __future__ import annotations

import json

#: bump on any breaking change to the line layouts above
METRICS_SCHEMA_VERSION = 1

_NUM = (int, float)
#: kind -> {field: required types}; bool is an int subclass, so numeric
#: fields explicitly reject it
_FIELDS = {
    "header": {"source": str, "wall_s": _NUM, "created_unix": _NUM},
    "gauge": {"t_us": _NUM, "lane": str, "name": str, "value": _NUM},
    "counter": {"name": str, "value": _NUM},
    "hist": {"name": str, "count": int, "min": _NUM, "max": _NUM,
             "mean": _NUM, "p50": _NUM, "p95": _NUM},
}


class SchemaError(ValueError):
    """A metrics log line violated the versioned schema."""


def validate_line(obj: dict, lineno: int = 0) -> str:
    """Validate one parsed line; returns its kind, raises SchemaError."""
    where = f"line {lineno}: " if lineno else ""
    if not isinstance(obj, dict):
        raise SchemaError(f"{where}expected a JSON object, got "
                          f"{type(obj).__name__}")
    v = obj.get("v")
    if v != METRICS_SCHEMA_VERSION:
        raise SchemaError(
            f"{where}schema version {v!r} != {METRICS_SCHEMA_VERSION} "
            "(this build validates only its own version)")
    kind = obj.get("kind")
    if kind not in _FIELDS:
        raise SchemaError(
            f"{where}unknown kind {kind!r}; want one of {sorted(_FIELDS)}")
    for field, types in _FIELDS[kind].items():
        if field not in obj:
            raise SchemaError(f"{where}{kind} line missing {field!r}")
        val = obj[field]
        if isinstance(val, bool) or not isinstance(val, types):
            raise SchemaError(
                f"{where}{kind}.{field} has type {type(val).__name__}, "
                f"want {types}")
    return kind


def validate_lines(lines) -> dict:
    """Validate a parsed log (iterable of dicts): per-line schema plus
    the structural rules (header exactly once, first).  Returns the
    per-kind line counts."""
    counts: dict = {}
    for i, obj in enumerate(lines, start=1):
        kind = validate_line(obj, i)
        if kind == "header" and i != 1:
            raise SchemaError(f"line {i}: header must be line 1 and unique")
        counts[kind] = counts.get(kind, 0) + 1
    if counts.get("header", 0) != 1:
        raise SchemaError(
            f"log has {counts.get('header', 0)} header lines, want exactly 1")
    return counts


def validate_metrics_log(path: str) -> dict:
    """Parse + validate a JSONL metrics file; returns per-kind counts."""
    parsed = []
    with open(path) as f:
        for i, raw in enumerate(f, start=1):
            raw = raw.strip()
            if not raw:
                raise SchemaError(f"line {i}: blank line in JSONL log")
            try:
                parsed.append(json.loads(raw))
            except json.JSONDecodeError as e:
                raise SchemaError(f"line {i}: not valid JSON: {e}") from e
    return validate_lines(parsed)


#: Chrome trace event phase -> {field: required types}, for
#: :meth:`repro_torch.obs.Tracer.chrome_trace`'s events
_TRACE_FIELDS = {
    "M": {"name": str, "pid": int, "tid": int, "args": dict},
    "X": {"name": str, "cat": str, "pid": int, "tid": int, "ts": _NUM,
          "dur": _NUM},
    "i": {"name": str, "cat": str, "pid": int, "tid": int, "ts": _NUM,
          "s": str},
    "C": {"name": str, "cat": str, "pid": int, "tid": int, "ts": _NUM,
          "args": dict},
}


def validate_chrome_trace(doc: dict) -> dict:
    """Validate a Chrome trace-event envelope (``Tracer.chrome_trace()``
    or a parsed ``export_chrome`` file): the envelope's keys, each event's
    required fields and types per phase, non-negative durations, thread-
    scoped instants, numeric counter samples, one process name, and a
    thread name for every lane an event uses.  Returns the per-phase event
    counts; raises :class:`SchemaError`."""
    if not isinstance(doc, dict) or set(doc) != {"traceEvents",
                                                 "displayTimeUnit"}:
        raise SchemaError("a trace is {'traceEvents': [...], "
                          "'displayTimeUnit': ...}")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise SchemaError("traceEvents must be a list")
    counts: dict = {}
    named, used, processes = set(), set(), 0
    for i, e in enumerate(events):
        ph = e.get("ph") if isinstance(e, dict) else None
        if ph not in _TRACE_FIELDS:
            raise SchemaError(f"event {i}: unknown phase {ph!r}")
        for field, types in _TRACE_FIELDS[ph].items():
            val = e.get(field)
            if isinstance(val, bool) or not isinstance(val, types):
                raise SchemaError(f"event {i} ({ph}): {field} is "
                                  f"{type(val).__name__}, want {types}")
        if ph == "M":
            if e["name"] == "process_name":
                processes += 1
            elif e["name"] == "thread_name":
                named.add(e["tid"])
            if not isinstance(e["args"].get("name"), str):
                raise SchemaError(f"event {i}: metadata without a name")
        else:
            used.add(e["tid"])
        if ph == "X" and e["dur"] < 0:
            raise SchemaError(f"event {i}: negative duration")
        if ph == "i" and e["s"] != "t":
            raise SchemaError(f"event {i}: instant scope {e['s']!r}")
        if ph == "C" and not all(
                isinstance(v, _NUM) and not isinstance(v, bool)
                for v in e["args"].values()):
            raise SchemaError(f"event {i}: non-numeric counter sample")
        counts[ph] = counts.get(ph, 0) + 1
    if processes != 1:
        raise SchemaError(f"trace names {processes} processes, want 1")
    if used - named:
        raise SchemaError(f"lanes {sorted(used - named)} have no name")
    return counts


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="validate a repro_torch.obs JSONL metrics log")
    ap.add_argument("path", help="metrics .jsonl file to validate")
    args = ap.parse_args(argv)
    counts = validate_metrics_log(args.path)
    total = sum(counts.values())
    print(f"{args.path}: {total} lines valid against metrics schema "
          f"v{METRICS_SCHEMA_VERSION} "
          f"({', '.join(f'{k}={v}' for k, v in sorted(counts.items()))})")


if __name__ == "__main__":
    main()
