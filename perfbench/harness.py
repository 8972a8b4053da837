"""The generic run of one cell: nothing here knows a cell, a
configuration, a lane or a metric by name.

1. The cell's entry in ``BENCHMARK.json`` names its configuration and
   traffic; the traffic names its lane (``perfbench.registry``).
2. The lane (``lanes/<lane>.py``: ``run(ctx) -> record``) sets up, warms
   the cell's own shapes, calls ``ctx.setup_done()``, measures for
   ``ctx.seconds``, with ``ctx.trace`` also a traced window
   (``ctx.traced()``), reads the device's peak memory, frees the
   program's state and checks what the timed path produced against the
   plain reference (``perfbench.judge``).
3. Each metric the cell reports is read from the record by its own
   reader (``metrics/<name>.py``: ``read(record)``, a number or None):
   with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1``
   its per-layer ones.  A reader that finds nothing returns None and the
   metric is left out of the line.
4. The result is one JSON line, the last of standard output; the numbers
   compared are also the last lines of standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

from . import registry
from .judge import passed

#: top-level module names that must not be loaded once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start(fallback: float) -> float:
    """The host time at which this process started (``/proc``), or
    ``fallback``."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        boot = time.time() - uptime
        start = boot + ticks / os.sysconf("SC_CLK_TCK")
        return start if start <= fallback else fallback
    except (OSError, ValueError, IndexError):
        return fallback


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def log(*parts) -> None:
    print("[perfbench]", *parts, file=sys.stderr, flush=True)


class Context:
    """What a lane is handed, and how it reports set-up and traces."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device, t0: float,
                 base: str = registry.HERE):
        self.cell, self.config, self.traffic = cell, config, traffic
        #: the benchmark's folder the cell's files were found in
        self.base = base
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0 = device, t0
        self.setup_s = None
        self.log = log

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> float:
        """Set-up ends here: the next step is the window's first.  What
        set-up left for the garbage collector is collected and frozen, so
        that no collection of it falls into the window."""
        gc.collect()
        gc.freeze()
        self.sync()
        self.setup_s = time.time() - self.t0
        return self.setup_s

    def tracer(self, host: bool = False) -> "Tracer":
        return Tracer(self.device, host)

    @contextlib.contextmanager
    def traced(self, out: dict, key: str = "trace", host: bool = False):
        """Profile the body between two device synchronisations;
        ``out[key]`` is then its reduced :class:`perfbench.trace.Trace`."""
        tr = self.tracer(host)
        self.sync()
        tr.start()
        yield
        self.sync()
        out[key] = tr.stop()


class Tracer:
    """``torch.profiler`` between ``start()`` and ``stop()``, which may be
    called from anywhere on the host thread, such as a serve's token
    callback; ``stop()`` returns the reduced window.

    The device's activities alone by default: recording every host
    operation slows a host-bound loop severalfold, and so would inflate
    the idle share it measures.  With ``host`` the host's operations are
    recorded too, to name what the host did across each idle gap."""

    def __init__(self, device, host: bool = False):
        self.device, self.host = device, host
        self.prof = self.span = None
        self.trace = None

    @property
    def running(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        from .trace import WINDOW_SPAN

        acts = [ProfilerActivity.CPU] if self.host or \
            self.device.type != "cuda" else []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.span = record_function(WINDOW_SPAN)
        self.span.__enter__()
        self.w0 = time.time_ns()

    def stop(self):
        from .trace import reduce

        t0 = time.perf_counter()
        w1 = time.time_ns()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.trace = reduce(self.prof, (self.w0, w1))
        self.prof = self.span = None
        log(f"trace: {len(self.trace.intervals)} device activities, "
            f"{len(self.trace.host)} host events, {self.trace.window_s:.3f} "
            f"s window, read in {time.perf_counter() - t0:.1f} s")
        return self.trace


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t0: float, base: str = registry.HERE,
             root: str = registry.ROOT) -> dict:
    """One run of the cell → its result (the line's object)."""
    import torch

    cell = registry.cell(bench, cell_name)
    cfg = registry.config(bench, cell["config"], root)
    traffic = registry.traffic(cell["traffic"], base)
    lane = registry.lane(traffic["lane"])
    e2e, per_layer = registry.cell_metrics(bench, cell_name)
    device = torch.device(device)
    ctx = Context(cell, cfg, traffic, seed, seconds, trace, device, t0, base)
    rec = lane.run(ctx)
    rec.update(config=cfg, traffic=traffic, setup_s=ctx.setup_s)
    metrics = {}
    for m in (per_layer if trace else e2e):
        value = registry.metric(m["name"], base).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": bool(passed(rec["checks"]) and not rec.get("errors")),
           "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown(rec.get("host_trace"))
    if rec.get("errors"):
        out["errors"] = rec["errors"][:5]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, v, lim in rec["checks"]}
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_import: float = None) -> int:
    args = parse(argv)
    t0 = process_start(t_import if t_import is not None else time.time())
    import torch

    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        log(f"the cell needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            "; no result")
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", t0)
    found = loaded_forbidden()
    if found:
        log(f"modules loaded that the port must not need: {found}; "
            "no result")
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
