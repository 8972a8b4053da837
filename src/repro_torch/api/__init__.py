"""`repro_torch.api` — one spec, run on the port (serving slice).

Mirrors `repro.api`::

    from repro_torch.api import ExperimentSpec, ServeJob, run
    res = run(ExperimentSpec(objective=ServeJob(arch="qwen2-0.5b"), T=16))

``run`` executes on CUDA unless a ``device`` is named.  Only the lock-step
serving lane is ported so far; see ROADMAP.md for the slices to come.
"""
from .spec import ExperimentSpec, StepsizePolicy, ServeJob
from .result import RunResult
from .backends import Backend, ServeBackend, run

__all__ = ["ExperimentSpec", "StepsizePolicy", "ServeJob", "RunResult",
           "Backend", "ServeBackend", "run"]
