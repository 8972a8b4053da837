"""Recapture sentinel: count the CUDA graph captures of the port's drivers.

Counterpart of ``repro/obs/compile_watch.py``.  There, a watch reads the
traced-signature count of each cached ``jax.jit``; a silent retrace turns
a compiled driver into a recompile-per-run one.  The port compiles no
programs at run time: what it builds once and replays is a CUDA graph, so
its watch counts **captures**:

* the slot server's K-step decode chunk (key ``chunk``, the JAX key),
* the simulator's replay graphs (``grid[G,chunk]`` for the chunk of ``G``
  stepsizes and ``grid[G,tail]`` for the ``T mod K`` tail; the JAX
  executor's γ-grid programs are keyed ``grid[n,mode]``).

Eager work (the slot server's prefills and admissions, a training round)
captures nothing and has no key.  :meth:`captured` is called by the
driver right after a capture; it records a ``compile`` trace instant (the
JAX event name) and a ``compiles`` count on the attached recorder.
:meth:`mark_steady` / :meth:`check_steady` hold the zero-steady-state
contract: once warm, any further capture raises :class:`RetraceError`
naming the program.
"""
from __future__ import annotations

from typing import Optional


class RetraceError(RuntimeError):
    """A watched program was captured again after
    :meth:`CompileWatch.mark_steady`."""


class CompileWatch:
    """Registry of captured programs and their capture counts."""

    def __init__(self, recorder=None, lane: str = "compile"):
        self.recorder = recorder
        self.lane = lane
        self._counts: dict = {}
        self._steady: Optional[dict] = None

    def register(self, name: str) -> None:
        """Track ``name`` with no capture yet (it shows as 0)."""
        self._counts.setdefault(name, 0)

    def captured(self, name: str) -> None:
        """Count one capture of ``name`` and trace it."""
        n = self._counts[name] = self._counts.get(name, 0) + 1
        rec = self.recorder
        if rec is not None:
            rec.instant("compile", lane=self.lane, fn=name, captures=n)
            rec.count("compiles")

    def counts(self) -> dict:
        """``{name: captures}`` for every registered program."""
        return dict(self._counts)

    # ------------------------------------------------------- steady contract
    def mark_steady(self) -> dict:
        """Snapshot the current counts as the allowed steady state (call
        once the driver is warm)."""
        self._steady = self.counts()
        return dict(self._steady)

    def check_steady(self) -> None:
        """Raise :class:`RetraceError` if any program was captured since
        :meth:`mark_steady`."""
        if self._steady is None:
            raise RetraceError(
                "check_steady() before mark_steady(): nothing to compare "
                "against")
        grown = {name: (self._steady.get(name, 0), now)
                 for name, now in self.counts().items()
                 if now > self._steady.get(name, 0)}
        if grown:
            detail = ", ".join(f"{n}: {a} -> {b}"
                               for n, (a, b) in sorted(grown.items()))
            raise RetraceError(
                f"steady-state recapture detected ({detail}) — a captured "
                "program was rebuilt for something that varies per call")
