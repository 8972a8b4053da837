"""A traced window reduced in memory: device intervals, their union, the
idle gaps and what the host was doing across each.

``torch.profiler`` records the window (CPU and CUDA activities); its raw
kineto events are read directly (building its per-op tables for the
hundreds of thousands of kernels of a serve takes minutes).  Nothing is
written to disk.  Device activities are every event on the CUDA device:
kernels, copies and memsets.  Their union, not their sum, is the busy
time, since kernels on two streams overlap.
"""
from __future__ import annotations

import functools
import heapq
from collections import defaultdict
from dataclasses import dataclass, field

#: name of the harness's span around the traced window
WINDOW_SPAN = "perfbench.window"
#: idle gaps shorter than this are not named one by one
GAP_MIN_NS = 2_000
SHORT_GAPS = "(gaps under 2 us)"
TOP = 10


@dataclass
class Trace:
    """One traced window: ``intervals`` are the device activities
    ``(start_ns, end_ns, name)`` clipped to the window ``[w0, w1]``, and
    ``host`` the CPU events ``(start_ns, end_ns, name)``."""
    w0: int
    w1: int
    intervals: list
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    @functools.cached_property
    def merged(self) -> list:
        """The union of the device intervals, as disjoint sorted spans."""
        out = []
        for s, e, _ in sorted(self.intervals):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged) / 1e9

    def device_seconds(self, match) -> tuple:
        """(summed seconds, count) of the device activities whose name
        ``match(name)`` accepts."""
        sel = [(e - s) for s, e, n in self.intervals if match(n)]
        return sum(sel) / 1e9, len(sel)

    def gaps(self) -> list:
        """The idle spans ``(start_ns, end_ns)`` of the window."""
        out, t = [], self.w0
        for s, e in self.merged:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.w1 > t:
            out.append((t, self.w1))
        return out

    def breakdown(self, host: "Trace" = None) -> dict:
        """The device operations that took most time, and the idle time
        by the innermost host operation across each gap's middle, the
        gaps and host operations those of ``host`` (a window traced with
        the host's operations) when it is given."""
        ops = defaultdict(int)
        for s, e, n in self.intervals:
            ops[n] += e - s
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = (host or self).idle_by_host()
        return {"device_ops": [[n, v / 1e9] for n, v in device_ops],
                "idle_gaps": [[n, v / 1e9] for n, v in gaps]}

    def idle_by_host(self) -> list:
        gaps = self.gaps()
        short = sum(e - s for s, e in gaps if e - s < GAP_MIN_NS)
        long_ = sorted((s + e) // 2 for s, e in gaps if e - s >= GAP_MIN_NS)
        width = {(s + e) // 2: e - s for s, e in gaps}
        names = innermost(self.host, long_)
        by = defaultdict(int)
        for mid in long_:
            by[names.get(mid, "(host between ops)")] += width[mid]
        if short:
            by[SHORT_GAPS] += short
        return sorted(by.items(), key=lambda kv: -kv[1])[:TOP]


def innermost(events: list, points: list) -> dict:
    """For each point (sorted ns), the name of the latest-starting host
    event ``(start, end, name)`` that contains it."""
    evs = sorted(events)
    out, active, i = {}, [], 0
    for t in points:
        while i < len(evs) and evs[i][0] <= t:
            s, e, n = evs[i]
            heapq.heappush(active, (-s, e, n))
            i += 1
        # an ended event below the top stays until it surfaces
        while active and active[0][1] <= t:
            heapq.heappop(active)
        if active:
            out[t] = active[0][2]
    return out


def reduce(prof, host_window: tuple) -> Trace:
    """The window between the harness's ``WINDOW_SPAN`` and the device
    and host events inside it, from a finished ``torch.profiler``.  A
    profiler that records the device's activities alone records no span:
    the window is then ``host_window``, the host's ``time.time_ns()`` at
    its ends (the profiler's clock)."""
    from torch.autograd import DeviceType

    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s = int(e.start_ns())
        end = s + int(e.duration_ns())
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # a span's mirror on the device's timeline is no activity
            if name != WINDOW_SPAN and not getattr(
                    e, "is_user_annotation", lambda: False)():
                dev.append((s, end, name))
        elif name == WINDOW_SPAN:
            window = (s, end)
        else:
            host.append((s, end, name))
    w0, w1 = window or host_window
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in dev
               if e > w0 and s < w1]
    host = [(s, e, n) for s, e, n in host if e > w0 and s < w1]
    return Trace(w0, w1, clipped, host)
