"""Hand-written CUDA kernels of the port, each beside its plain version.

``ops`` holds the entry points; ``csrc/`` the CUDA sources, built at first
use by ``_build``.
"""
