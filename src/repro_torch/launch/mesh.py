"""H100 constants and meshes: axis-size descriptors, and meshes bound to the
processes of a ``torch.distributed`` group.

Counterpart of ``repro/launch/mesh.py``.  A :class:`Mesh` is a descriptor:
a dict of axis sizes (``.shape``) and their names in order
(``.axis_names``), the duck type the sharding rules read; the dry-run
shards its analytic state over the production meshes with it.  A
:class:`ProcessMesh` is the same descriptor bound to the initialised
process group, one rank per device: ranks sit on the mesh row-major over
its axes (the last axis fastest, as ``jax.make_mesh`` lays out devices),
so rank ``r`` has the coordinates ``numpy.unravel_index(r, sizes)``.  It
holds one process group per mesh axis and one for the data axes
flattened (pod × data, the ZeRO domain of the pooled update), and knows
this rank's coordinates.  A mesh whose device count differs from the
world size is an error, as ``jax.make_mesh`` fails without the devices.

What runs on a bound mesh: data parallelism over the data axes (the
AsGrad trainer, :mod:`repro_torch.distributed.async_trainer`) and, for
every family, tensor parallelism over the ``model`` axis
(:mod:`repro_torch.models.tp`; the trainer, the lock-step ``Server`` and
the ``SlotServer``),
each rank holding its blocks of the params, the cache and the optimizer
state; :func:`make_host_mesh` (data 1, model = the world) runs them.  A
:class:`TracedMesh` is one rank of a mesh bound to no process group, its
collectives stand-ins that count their bytes: the dry-run traces a rank
of the production meshes with it.  The production layout puts one 8-GPU
NVLink node on the model axis.

The constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet: dense
rates at the 700 W power limit.  A card set below that limit runs slower
under load, so a share of these peaks is quoted with the card's limit.

Importing this module touches no CUDA state and no process group.
"""
from __future__ import annotations

import math
import os
import tempfile

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores, dense
PEAK_FLOPS_F32 = 67e12        # FLOP/s, CUDA cores
HBM_BW = 3.35e12              # B/s
HBM_BYTES = 80e9              # B of HBM3
NVLINK_BW = 450e9             # B/s per direction per GPU (NVLink 4)


class Mesh:
    """Axis sizes by name: ``Mesh({"data": 32, "model": 8})``.  A
    descriptor, bound to no process."""

    bound = False

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    def coords_of(self, rank: int) -> dict:
        """The coordinates of ``rank`` on the mesh (row-major, the last
        axis fastest)."""
        coords = {}
        for a in reversed(self.axis_names):
            rank, coords[a] = divmod(rank, self.shape[a])
        return {a: coords[a] for a in self.axis_names}

    def count(self, axes) -> int:
        """Devices along ``axes`` (an axis absent from the mesh counts 1)."""
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axes, coords: dict) -> int:
        """The row-major position of ``coords`` along ``axes`` flattened
        (pod × data: ``pod · D + data``), the shard a dim sharded over
        ``axes`` gives those coordinates."""
        i = 0
        for a in axes:
            if a in self.shape:
                i = i * self.shape[a] + coords[a]
        return i

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


class ProcessMesh(Mesh):
    """A mesh bound to the initialised default process group: this rank's
    ``coords``, and a process group per axis and for the data axes
    flattened (:meth:`group`).  Every rank builds it with the same shape,
    in the same order relative to other group creations (each group is a
    collective call on the whole world)."""

    bound = True

    def __init__(self, shape: dict):
        import torch.distributed as dist

        from ..distributed.sharding import DEFAULT_RULES

        super().__init__(shape)
        if not dist.is_initialized():
            raise RuntimeError("a ProcessMesh needs an initialised process "
                               "group (launch.mesh.init_process_group)")
        world = dist.get_world_size()
        n = mesh_devices(self)
        if n != world:
            raise ValueError(
                f"mesh {self.shape} has {n} devices but the process group "
                f"has {world} ranks")
        self.rank = dist.get_rank()
        self.world = world
        self.coords = self.coords_of(self.rank)
        self._groups: dict = {}
        data = tuple(a for a in DEFAULT_RULES.data_axes if a in self.shape)
        for axes in [(a,) for a in self.axis_names] + [data]:
            if axes and axes not in self._groups:
                self._groups[axes] = self._new_group(axes)

    def _blocks(self, axes) -> list:
        """The ranks of each group along ``axes``: ranks that differ only
        in their coordinates on ``axes``, ordered by their position
        there."""
        blocks: dict = {}
        for r in range(self.world):
            c = self.coords_of(r)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            blocks.setdefault(key, []).append((self.index(axes, c), r))
        return [[r for _, r in sorted(b)] for _, b in sorted(blocks.items())]

    def _new_group(self, axes):
        import torch.distributed as dist

        blocks = self._blocks(axes)
        if len(blocks) == 1:          # the whole world, in rank order
            return dist.group.WORLD
        group, _ = dist.new_subgroups_by_enumeration(blocks)
        return group

    def group(self, axes):
        """The process group of this rank along ``axes`` (a tuple of axis
        names; the data axes flattened is one of them)."""
        axes = tuple(a for a in axes if a in self.shape)
        if axes not in self._groups:
            raise KeyError(f"no process group along {axes}; the mesh holds "
                           f"{sorted(self._groups)}")
        return self._groups[axes]

    def my_index(self, axes) -> int:
        """This rank's position along ``axes`` flattened."""
        return self.index(axes, self.coords)


class TracedMesh(Mesh):
    """Rank ``rank`` of a mesh of ``shape``, bound to no process group: its
    coordinates, and per axis a stand-in group
    (``distributed.collectives.TracedGroup``) whose collectives return
    their outputs' shapes and count their operand bytes in the active
    ``launch/op_cost.py`` tally.  The model code and the trainer run on it
    as on a :class:`ProcessMesh`, so one rank's step of a mesh of any size
    can be traced on ``meta`` by one process."""

    bound = True

    def __init__(self, shape: dict, rank: int = 0):
        super().__init__(shape)
        self.rank = rank
        self.world = mesh_devices(self)
        self.coords = self.coords_of(rank)

    def group(self, axes):
        from ..distributed.collectives import TracedGroup
        return TracedGroup(self.count(axes))

    def my_index(self, axes) -> int:
        return self.index(axes, self.coords)


def init_process_group(device) -> None:
    """Initialise ``torch.distributed`` for ``device``: NCCL on a card,
    gloo on the CPU.  Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in
    the environment) it joins the launcher's rendezvous, and a card process
    takes card ``LOCAL_RANK``; otherwise it is a world of one, through a
    file store in a fresh temporary directory."""
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        return
    store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=0, world_size=1)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """32 nodes of 8 GPUs (256), or two pods of them (512)."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 32, "model": 8})
    return Mesh({"data": 32, "model": 8})


def make_host_mesh(world: int | None = None) -> Mesh:
    """Whatever this host runs, as (data=1, model=n): n is ``world`` (the
    launcher's process count), else the process group's world size (one
    rank per device), or 1 without a group."""
    if world is None:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh({"data": 1, "model": world})


def mesh_devices(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh.axis_names)
