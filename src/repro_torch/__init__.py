"""`repro_torch` — the PyTorch / CUDA port of the `repro` package.

Module paths mirror `repro/` (``repro_torch/models/model.py`` is the
counterpart of ``repro/models/model.py``).  The port imports torch and
numpy, never JAX and nothing of `repro`; it keeps its own copies of the
framework-free modules it needs.  Entry points run on ``device="cuda"``
unless the caller names another device, and raise when CUDA is absent.

This slice carries the lock-step serving path of the dense family:
``api.run(ExperimentSpec(objective=ServeJob(...)))`` → prefill (whose
attention is the hand-written CUDA kernel ``kernels/flash_attention``
when ``use_flash_attention`` is set) → greedy / temperature decode.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
