"""`repro_torch` — the PyTorch / CUDA port of the `repro` package.

Module paths mirror `repro/` (``repro_torch/models/model.py`` is the
counterpart of ``repro/models/model.py``).  The port imports torch and
numpy, never JAX and nothing of `repro`; it keeps its own copies of the
framework-free modules it needs.  Entry points run on ``device="cuda"``
unless the caller names another device, and raise when CUDA is absent.

``api.run(ExperimentSpec(...))`` dispatches on the objective: a
``ServeJob`` to the lock-step serving lane (dense and SSM families, with
the hand-written CUDA kernels ``kernels/flash_attention`` and
``kernels/ssd_chunk``), a ``TrainJob`` to the asynchronous trainer (its
server update through ``kernels/async_update``), and a problem exposing
``grad_fn`` (``objectives``) to the theory tier's exact replay, which runs
as CUDA graph chunks of torch ops.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
