"""H100 constants and mesh descriptors for the launch tier.

Counterpart of ``repro/launch/mesh.py``.  The port has no SPMD partitioner,
so a mesh here is a plain descriptor: a dict of axis sizes (``.shape``) and
their names in order (``.axis_names``), the duck type the sharding rules
read.  The production layout puts one 8-GPU NVLink node on the model axis.

The constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet: dense
rates at the 700 W power limit.  A card set below that limit runs slower
under load, so a share of these peaks is quoted with the card's limit.

Importing this module touches no CUDA state: :func:`make_host_mesh` asks
for the device count only when it is called.
"""
from __future__ import annotations

import math

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores, dense
PEAK_FLOPS_F32 = 67e12        # FLOP/s, CUDA cores
HBM_BW = 3.35e12              # B/s
HBM_BYTES = 80e9              # B of HBM3
NVLINK_BW = 450e9             # B/s per direction per GPU (NVLink 4)


class Mesh:
    """Axis sizes by name: ``Mesh({"data": 32, "model": 8})``."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """32 nodes of 8 GPUs (256), or two pods of them (512)."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 32, "model": 8})
    return Mesh({"data": 32, "model": 8})


def make_host_mesh() -> Mesh:
    """Whatever this host has as (data=1, model=n): n visible cards, or 1
    without CUDA."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return Mesh({"data": 1, "model": max(n, 1)})


def mesh_devices(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh.axis_names)
