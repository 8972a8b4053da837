"""Unified result type returned by every backend."""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np

#: payload-format tag for archived results; bump on breaking layout change
RESULT_JSON_VERSION = 1

#: arrays above this size archive as a (shape, dtype, ‖·‖₂) summary stub —
#: curves and masks round-trip exactly, 300M-param state trees do not
_MAX_ARRAY_ELEMS = 1 << 16


def _jsonable(v, _depth=0):
    """Best-effort JSON encoding: ndarrays → tagged dtype+list (restored as
    arrays), dataclasses → tagged field dicts, non-encodable leaves (device
    state trees, schedule objects) → a tagged ``repr`` stub."""
    if _depth > 12:
        return {"__repr__": repr(v)}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        if v.size > _MAX_ARRAY_ELEMS:      # big state leaves: diffable stub
            try:
                l2 = float(np.linalg.norm(v.astype(np.float64).ravel()))
            except (TypeError, ValueError):
                l2 = None
            return {"__array_summary__": {
                "shape": list(v.shape), "dtype": str(v.dtype), "l2": l2}}
        return {"__ndarray__": {"dtype": str(v.dtype),
                                "data": v.tolist()}}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {"__dataclass__": type(v).__name__,
                "fields": {f.name: _jsonable(getattr(v, f.name), _depth + 1)
                           for f in dataclasses.fields(v)}}
    if isinstance(v, dict):
        return {str(k): _jsonable(x, _depth + 1) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x, _depth + 1) for x in v]
    try:                                   # device arrays and array-likes
        arr = np.asarray(v)
        if arr.dtype != object:
            return _jsonable(arr, _depth + 1)
    except Exception:
        pass
    return {"__repr__": repr(v)}


def _restore_grid(grid):
    """Grid keys are the γ floats; JSON stringifies them — undo that."""
    if not isinstance(grid, dict):
        return grid
    out = {}
    for k, v in grid.items():
        try:
            out[float(k)] = v
        except (TypeError, ValueError):
            out[k] = v
    return out


def _from_jsonable(v):
    if isinstance(v, dict):
        if "__ndarray__" in v:
            nd = v["__ndarray__"]
            try:
                dt = np.dtype(nd["dtype"])
            except TypeError:              # e.g. bfloat16 w/o ml_dtypes
                dt = np.float32
            return np.asarray(nd["data"], dtype=dt)
        if "__array_summary__" in v:
            return v                       # stub stays a stub
        if "__dataclass__" in v:           # restored as a plain field dict
            return {"__dataclass__": v["__dataclass__"],
                    **{k: _from_jsonable(x)
                       for k, x in v["fields"].items()}}
        if "__repr__" in v:
            return v["__repr__"]
        return {k: _from_jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    return v


@dataclasses.dataclass
class RunResult:
    """What an AsGrad run produced, backend-independent.

    ``x`` is the final iterate (simulator), the final train state tree
    (trainer), or the generated tokens (serve).  ``trace`` carries the
    realised-schedule statistics the theory bounds reference (τ_max, τ_avg,
    τ_C, job balance); ``grid`` holds the per-γ curves when a stepsize grid
    search ran.
    """

    spec: Any
    backend: str
    x: Any = None
    log_ts: Optional[np.ndarray] = None
    grad_norms: Optional[np.ndarray] = None
    losses: Optional[np.ndarray] = None
    xs: Optional[np.ndarray] = None          # iterate snapshots (simulator)
    gamma: Optional[float] = None            # the (selected) server stepsize
    grid: Optional[dict] = None              # γ → {"grad_norms", "losses", "score"}
    schedule: Any = None                     # realised Schedule, if one was built
    trace: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def final_grad_norm(self) -> Optional[float]:
        if self.grad_norms is None or not len(self.grad_norms):
            return None
        return float(self.grad_norms[-1])

    @property
    def final_loss(self) -> Optional[float]:
        if self.losses is None or not len(self.losses):
            return None
        return float(self.losses[-1])

    # ------------------------------------------------------------- archiving
    def to_json(self) -> str:
        """Archive-grade JSON: curves and grid arrays round-trip exactly
        (dtype-tagged lists), while the non-serialisable heavyweights are
        *summarised* — the realised ``schedule`` collapses to its
        statistics (T, wait_b, n_workers + the τ trace), ``spec`` to its
        field dict, and a trainer-state ``x`` to a repr stub.  The output
        is what CI artifacts and cross-PR diffs consume; see
        :meth:`from_json` for the (documented lossy) inverse."""
        sched = None
        if self.schedule is not None:
            s = self.schedule
            sched = {"T": int(s.T), "wait_b": int(s.wait_b),
                     "n_workers": int(s.n_workers),
                     "tau_max": int(s.tau_max()),
                     "tau_avg": float(s.tau_avg()),
                     "tau_c": int(s.tau_c())}
        payload = {
            "version": RESULT_JSON_VERSION,
            "backend": self.backend,
            "spec": _jsonable(self.spec),
            "x": _jsonable(self.x),
            "log_ts": _jsonable(self.log_ts),
            "grad_norms": _jsonable(self.grad_norms),
            "losses": _jsonable(self.losses),
            "xs": _jsonable(self.xs),
            "gamma": self.gamma,
            "grid": _jsonable(self.grid),
            "schedule": sched,
            "trace": _jsonable(self.trace),
            "seconds": self.seconds,
            "extra": _jsonable(self.extra),
        }
        return json.dumps(payload, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "RunResult":
        """Inverse of :meth:`to_json`.  Arrays come back as numpy arrays
        with their original dtypes; ``spec`` and ``schedule`` come back as
        the plain summary dicts the archive stored (NOT live
        ``ExperimentSpec``/``Schedule`` objects), and repr-stubbed fields
        (e.g. a trainer-state ``x``) come back as their repr strings —
        enough to diff runs across PRs, not to resume them."""
        d = json.loads(text)
        version = d.get("version")
        if version != RESULT_JSON_VERSION:
            raise ValueError(
                f"unsupported RunResult JSON version {version!r} "
                f"(this build reads {RESULT_JSON_VERSION})")
        return cls(
            spec=_from_jsonable(d["spec"]),
            backend=d["backend"],
            x=_from_jsonable(d["x"]),
            log_ts=_from_jsonable(d["log_ts"]),
            grad_norms=_from_jsonable(d["grad_norms"]),
            losses=_from_jsonable(d["losses"]),
            xs=_from_jsonable(d["xs"]),
            gamma=d["gamma"],
            grid=_restore_grid(_from_jsonable(d["grid"])),
            schedule=d["schedule"],
            trace=_from_jsonable(d["trace"]) or {},
            seconds=d["seconds"],
            extra=_from_jsonable(d["extra"]) or {},
        )
