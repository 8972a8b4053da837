"""Logical-axis sharding rules with divisibility fallback: the rule half.

Counterpart of ``repro/distributed/sharding.py``.  Every tensor of the
system (params, optimizer state, caches, batches) carries logical axis
names (see ``models.specs.Spec``).  Rules map logical names to mesh axes; a
candidate that does not divide the dimension is skipped rather than
erroring (grok-1's 8 KV heads on a 16-way model axis fall through to the
next candidate).  At most one tensor dim gets each mesh axis; priority order
decides who wins.

A partition spec is a :class:`PSpec`: a tuple with one entry per tensor dim
(a mesh axis name, a tuple of them, or ``None``), element for element what
``jax.sharding.PartitionSpec`` holds.  A mesh is anything with ``.shape``
(axis sizes by name) and ``.axis_names`` (``launch.mesh.Mesh``).

The port runs on one device, so here the rules only count: the dry-run's
analytic per-device state on the production H100 meshes
(:func:`bytes_per_device`).  The half that needs a process group waits for
multi-GPU (ROADMAP.md queue 1, item 14): ``activation_sharding``,
``shard_activation``, ``sharded_trace`` and ``tree_shardings``.
:func:`data_shard_count` is 1, since no activation context exists.
"""
from __future__ import annotations

import dataclasses
import math

from ..models.specs import Spec, torch_dtype
from ..tree import tree_leaves, tree_map


class PSpec(tuple):
    """``PSpec("data", None)``: one entry per tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    """model_priority: logical names that want the tensor-parallel axis, in
    decreasing priority.  batch_names: names sharded over the data axes."""

    model_priority: tuple = (
        "experts", "heads", "kv_heads", "ctx", "d_inner", "ssm_heads",
        "ff", "vocab", "embed",
    )
    batch_names: tuple = ("batch", "capacity")
    data_axes: tuple = ("pod", "data")      # outer-to-inner data parallelism
    model_axis: str = "model"
    # ZeRO/FSDP: additionally shard params + optimizer state over the data
    # axes on the first divisible *tensor* dim that is still replicated;
    # never the "layers" dim (a layers-sharded stack sliced at a dynamic
    # index gathers the whole stack)
    zero_names: tuple = ("embed", "ff", "heads", "kv_heads", "d_inner",
                         "vocab", "experts", "ssm_heads", "ctx")


DEFAULT_RULES = Rules()

SEQ_PARALLEL_RULES = Rules(
    model_priority=DEFAULT_RULES.model_priority + ("seq",))


def auto_rules(cfg, model_axis_size: int = 16) -> Rules:
    """Pick the sharding rules per arch: archs whose attention heads cannot
    shard across the model axis (qwen2's 14 heads, ...) take sequence
    parallelism; archs with shardable heads (or an SSM whose heads shard)
    keep the default."""
    heads_ok = cfg.n_heads and cfg.n_heads % model_axis_size == 0
    ssm_ok = cfg.ssm_state and cfg.ssm_heads % model_axis_size == 0
    if heads_ok or (cfg.family == "ssm" and ssm_ok):
        return DEFAULT_RULES
    return SEQ_PARALLEL_RULES


def data_shard_count() -> int:
    """Data-parallel shards of the active activation context: 1, since the
    port has none yet (item 14)."""
    return 1


def _mesh_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def logical_pspec(axes, shape, mesh, rules: Rules = DEFAULT_RULES) -> PSpec:
    """Build the partition spec of one tensor from its logical axes."""
    if axes is None:
        return PSpec()
    assignment: list = [None] * len(axes)
    used: set = set()

    # 1) batch dims over the data axes (pod × data if both divide); each
    #    mesh axis is consumed at most once even if several dims are
    #    batch-named
    for i, ax in enumerate(axes):
        if ax in rules.batch_names:
            present = [a for a in rules.data_axes
                       if a in mesh.axis_names and a not in used]
            if not present:
                continue
            prod = math.prod(_mesh_size(mesh, a) for a in present)
            if shape[i] % prod == 0:
                assignment[i] = tuple(present) if len(present) > 1 else present[0]
                used.update(present)
            else:
                for a in reversed(present):       # try inner axis alone
                    if shape[i] % _mesh_size(mesh, a) == 0:
                        assignment[i] = a
                        used.add(a)
                        break

    # 2) one dim gets the model axis, by priority, if divisible
    msz = _mesh_size(mesh, rules.model_axis)
    if rules.model_axis in mesh.axis_names and msz > 1:
        for name in rules.model_priority:
            if rules.model_axis in used:
                break
            for i, ax in enumerate(axes):
                if ax == name and assignment[i] is None and shape[i] % msz == 0 \
                        and shape[i] >= msz:
                    assignment[i] = rules.model_axis
                    used.add(rules.model_axis)
                    break
    return PSpec(*assignment)


def zero_pspec(axes, shape, mesh, base: PSpec,
               rules: Rules = DEFAULT_RULES) -> PSpec:
    """Optimizer-state sharding: param spec + data-axis sharding on the first
    still-replicated dim named in ``zero_names`` (ZeRO-1 style)."""
    present = [a for a in rules.data_axes if a in mesh.axis_names]
    if not present:
        return base
    spec = list(base) + [None] * (len(shape) - len(base))
    used = {a for s in spec if s is not None
            for a in (s if isinstance(s, tuple) else (s,))}
    free = [a for a in present if a not in used]
    if not free:
        return base
    prod = math.prod(_mesh_size(mesh, a) for a in free)
    for name in rules.zero_names:
        for i, ax in enumerate(axes or ()):
            if ax == name and spec[i] is None and shape[i] % prod == 0 \
                    and shape[i] >= prod:
                spec[i] = tuple(free) if len(free) > 1 else free[0]
                return PSpec(*spec)
    return base


def pool_axes(mesh, rules: Rules = DEFAULT_RULES) -> tuple:
    """The mesh data axes a pooled state buffer shards over (the ZeRO
    domain), in rules order."""
    return tuple(a for a in rules.data_axes if a in mesh.axis_names)


def pool_shard_count(mesh, rules: Rules = DEFAULT_RULES) -> int:
    """Row count of the pooled ``(n_shards, cols)`` buffers: one row per
    ZeRO shard (1 on data-parallel-free meshes)."""
    return math.prod(mesh.shape[a] for a in pool_axes(mesh, rules)) or 1


def pooled_pspec(mesh, rules: Rules = DEFAULT_RULES) -> PSpec:
    """Partition spec of a pooled ``(n_shards, cols)`` state buffer: rows
    over the data axes, columns unsharded, replicated over the model
    axis."""
    axes = pool_axes(mesh, rules)
    if not axes:
        return PSpec(None, None)
    return PSpec(axes if len(axes) > 1 else axes[0], None)


def _leaf_pspec(s: Spec, mesh, rules: Rules, zero: bool) -> PSpec:
    p = logical_pspec(s.axes, s.shape, mesh, rules)
    if zero:
        p = zero_pspec(s.axes, s.shape, mesh, p, rules)
    return p


def tree_pspecs(spec_tree, mesh, rules: Rules = DEFAULT_RULES,
                zero: bool = False):
    """Map a Spec tree → a PSpec tree of the same paths."""
    return tree_map(lambda s: _leaf_pspec(s, mesh, rules, zero), spec_tree)


def bytes_per_device(spec_tree, mesh, rules: Rules = DEFAULT_RULES,
                     zero: bool = False) -> int:
    """Analytic per-device bytes of a Spec tree under the rules."""
    total = 0
    for s in tree_leaves(spec_tree):
        shards = 1
        for e in _leaf_pspec(s, mesh, rules, zero):
            for a in (e if isinstance(e, tuple) else (e,)) if e else ():
                shards *= _mesh_size(mesh, a)
        total += math.prod(s.shape) * torch_dtype(s.dtype).itemsize // shards
    return total
