"""`repro_torch.api` — one spec, run on the port.

Mirrors `repro.api`::

    from repro_torch.api import ExperimentSpec, TrainJob, ServeJob, run
    res = run(ExperimentSpec(objective=TrainJob(update_impl="pallas"), T=8))
    res = run(ExperimentSpec(objective=ServeJob(arch="qwen2-0.5b"), T=16))
    res = run(ExperimentSpec(objective=LogRegProblem(A, b), T=3000,
                             stepsize=grid(0.005, 0.002, 0.0005)))

``run`` executes on CUDA unless a ``device`` is named.  The simulator, the
trainer and the lock-step serving lane are ported; see ROADMAP.md for the
slices to come.
"""
from .spec import (ExperimentSpec, StepsizePolicy, ServeJob, TrainJob,
                   constant, grid, delay_adaptive, parse_compact)
from .result import RunResult
from .backends import (Backend, ServeBackend, SimulatorBackend,
                       TrainerBackend, run)

__all__ = ["ExperimentSpec", "StepsizePolicy", "ServeJob", "TrainJob",
           "constant", "grid", "delay_adaptive", "parse_compact",
           "RunResult", "Backend", "SimulatorBackend", "ServeBackend",
           "TrainerBackend", "run"]
