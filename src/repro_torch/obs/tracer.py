"""Zero-dependency tracing + metrics core.

Counterpart of ``repro/obs/tracer.py``, copied: the module is
framework-free; the trace's process is named ``repro_torch``.

One :class:`Tracer` per run collects three event families, all host-side
and all timestamped with ``time.perf_counter_ns()`` at EXISTING host
boundaries (chunk edges, metric reads, admission sweeps) — tracing never
introduces a device sync.  On a CUDA card a span therefore measures the
host's time to enqueue the work it encloses, not the device's time:

* **spans** — named intervals (``launch``, ``host_sync``, ``admit``,
  ``snapshot_finalise``, ...) grouped into *lanes* (one Perfetto track
  per lane: executor / tap / snapshot / server / faults / per-slot).
* **instants** — point events (``tap_round``, ``guard_skip``, ``evict``,
  ``compile``, ``breaker_trip``).
* **metrics** — cumulative counters (``launches``, ``tap_events``),
  timestamped gauges (``occupancy``, ``gscale``) and histograms
  (``ttft_steps``, ``chunk_seconds``) that export to a JSONL log with a
  versioned schema (:mod:`repro_torch.obs.schema`).

Exports:

* :meth:`Tracer.chrome_trace` / :meth:`Tracer.export_chrome` — Chrome
  trace-event JSON (the ``{"traceEvents": [...]}`` envelope), loadable
  in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.
* :meth:`Tracer.metrics_lines` / :meth:`Tracer.export_metrics` — the
  JSONL metrics log (one schema-versioned JSON object per line).

Thread safety: every mutation takes ``self._lock`` (the critical section
is one list append), so spans may be recorded from more than one thread,
as in the JAX package, whose taps fire from callback threads.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager


def _json_safe(v):
    """Span/instant args must survive json.dumps: numpy scalars and other
    exotica degrade to float/repr instead of blowing up the export."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


class Tracer:
    """Collects spans / instants / metrics; exports Chrome trace + JSONL."""

    def __init__(self):
        self._t0 = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._spans = []        # (name, lane, start_ns, dur_ns, args|None)
        self._instants = []     # (name, lane, ts_ns, args|None)
        self._counters = {}     # name -> cumulative value
        self._gauges = []       # (ts_ns, lane, name, value)
        self._hists = {}        # name -> [values]
        self._lanes = {}        # lane name -> tid (stable, first-seen order)

    # ------------------------------------------------------------------ time
    def now_ns(self) -> int:
        """Monotonic nanoseconds since this tracer was created (the trace
        clock origin); pair with :meth:`span_at` for lifetimes that start
        and end at different host boundaries."""
        return time.perf_counter_ns() - self._t0

    @property
    def wall_s(self) -> float:
        return self.now_ns() / 1e9

    def _tid(self, lane: str) -> int:
        tid = self._lanes.get(lane)
        if tid is None:
            tid = self._lanes[lane] = len(self._lanes)
        return tid

    # ----------------------------------------------------------------- spans
    @contextmanager
    def span(self, name: str, lane: str = "main", **args):
        """Record the enclosed block as a complete ('X') trace event."""
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            end = time.perf_counter_ns()
            with self._lock:
                self._tid(lane)
                self._spans.append(
                    (name, lane, start - self._t0, end - start,
                     args or None))

    def span_at(self, name: str, lane: str, start_ns: int, end_ns: int,
                **args) -> None:
        """Record a span whose endpoints were captured earlier with
        :meth:`now_ns` (e.g. a request's admit→completion lifetime)."""
        with self._lock:
            self._tid(lane)
            self._spans.append(
                (name, lane, int(start_ns), int(end_ns - start_ns),
                 args or None))

    def instant(self, name: str, lane: str = "main", **args) -> None:
        # the tap hot path: one of these per round — inline the clock
        # read and lane registration instead of delegating
        ts = time.perf_counter_ns() - self._t0
        with self._lock:
            if lane not in self._lanes:
                self._lanes[lane] = len(self._lanes)
            self._instants.append((name, lane, ts, args or None))

    # --------------------------------------------------------------- metrics
    def count(self, name: str, inc: int = 1) -> None:
        """Bump a cumulative counter (exported once, as its final value)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value: float, lane: str = "main") -> None:
        """Record a timestamped point sample (also a Chrome 'C' event, so
        Perfetto draws the time series)."""
        ts = self.now_ns()
        with self._lock:
            self._tid(lane)
            self._gauges.append((ts, lane, name, float(value)))

    def hist(self, name: str, value: float) -> None:
        """Accumulate one histogram sample (exported as a summary line)."""
        with self._lock:
            self._hists.setdefault(name, []).append(float(value))

    # -------------------------------------------------------------- snapshots
    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def phase_table(self) -> dict:
        """Aggregate spans by name: where the host-visible wall time went.

        ``{name: {"count": n, "total_s": s, "mean_ms": m}}`` — the
        time-in-phase breakdown :func:`repro_torch.obs.render_summary` renders.
        Lanes run concurrently (a request span overlaps the launch spans
        that decode it), so totals are per-phase occupancy, not a
        partition of wall time.
        """
        with self._lock:
            spans = list(self._spans)
        out = {}
        for name, _lane, _start, dur, _args in spans:
            e = out.setdefault(name, {"count": 0, "total_s": 0.0})
            e["count"] += 1
            e["total_s"] += dur / 1e9
        for e in out.values():
            e["total_s"] = round(e["total_s"], 6)
            e["mean_ms"] = round(e["total_s"] * 1e3 / e["count"], 4)
        return out

    def hist_summaries(self) -> dict:
        with self._lock:
            hists = {k: list(v) for k, v in self._hists.items()}
        out = {}
        for name, vals in hists.items():
            vs = sorted(vals)
            n = len(vs)
            out[name] = {
                "count": n,
                "min": vs[0], "max": vs[-1],
                "mean": round(sum(vs) / n, 6),
                "p50": vs[n // 2],
                "p95": vs[min(n - 1, int(0.95 * n))],
            }
        return out

    # ------------------------------------------------------- chrome export
    def chrome_trace(self) -> dict:
        """The Chrome trace-event envelope (JSON-ready dict).

        Spans are 'X' (complete) events, instants 'i' (thread-scoped),
        gauges 'C' (counter) events; lanes become named threads of one
        ``repro_torch`` process via 'M' metadata events.  Timestamps are
        microseconds on the tracer's monotonic clock.
        """
        with self._lock:
            spans = list(self._spans)
            instants = list(self._instants)
            gauges = list(self._gauges)
            lanes = dict(self._lanes)
        ev = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
               "args": {"name": "repro_torch"}}]
        for lane, tid in lanes.items():
            ev.append({"ph": "M", "name": "thread_name", "pid": 0,
                       "tid": tid, "args": {"name": lane}})
        for name, lane, start, dur, args in spans:
            e = {"ph": "X", "name": name, "cat": lane, "pid": 0,
                 "tid": lanes.get(lane, 0), "ts": start / 1e3,
                 "dur": max(dur, 0) / 1e3}
            if args:
                e["args"] = {k: _json_safe(v) for k, v in args.items()}
            ev.append(e)
        for name, lane, ts, args in instants:
            e = {"ph": "i", "name": name, "cat": lane, "pid": 0,
                 "tid": lanes.get(lane, 0), "ts": ts / 1e3, "s": "t"}
            if args:
                e["args"] = {k: _json_safe(v) for k, v in args.items()}
            ev.append(e)
        for ts, lane, name, value in gauges:
            ev.append({"ph": "C", "name": name, "cat": lane, "pid": 0,
                       "tid": lanes.get(lane, 0), "ts": ts / 1e3,
                       "args": {name: value}})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    # -------------------------------------------------------- metrics export
    def metrics_lines(self) -> list:
        """The JSONL metrics log as a list of dicts (see
        :mod:`repro_torch.obs.schema` for the per-line contract): one header,
        the chronological gauge samples, then final counter values and
        histogram summaries."""
        from .schema import METRICS_SCHEMA_VERSION as V

        lines = [{"v": V, "kind": "header", "source": "repro_torch.obs",
                  "wall_s": round(self.wall_s, 6),
                  "created_unix": time.time()}]
        with self._lock:
            gauges = list(self._gauges)
            counters = dict(self._counters)
        for ts, lane, name, value in gauges:
            lines.append({"v": V, "kind": "gauge", "t_us": ts / 1e3,
                          "lane": lane, "name": name, "value": value})
        for name, value in sorted(counters.items()):
            lines.append({"v": V, "kind": "counter", "name": name,
                          "value": value})
        for name, summ in sorted(self.hist_summaries().items()):
            lines.append({"v": V, "kind": "hist", "name": name, **summ})
        return lines

    def export_metrics(self, path: str) -> str:
        with open(path, "w") as f:
            for line in self.metrics_lines():
                f.write(json.dumps(line) + "\n")
        return path
