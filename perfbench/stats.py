"""Order statistics of the metric readers."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0–100) of all ``values``, by linear
    interpolation between the closest ranks (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def request_p95_ms(rec: dict, key: str):
    """The 95th percentile in ms of ``key`` (seconds, one a request) over
    every request of the window's serves; None with no request."""
    xs = [x for s in rec.get("serves", ()) for x in s[key]]
    return percentile(xs, 95) * 1e3 if xs else None
