"""Logical-axis sharding rules with divisibility fallback, and their process
half.

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

The rules count everywhere: the dry-run's analytic per-device state on the
production H100 meshes (:func:`bytes_per_device`).  The process half runs
on a mesh bound to a process group (``launch.mesh.ProcessMesh``), one rank
per device, where the data axes are data parallelism:

* :class:`NamedSharding` (mesh + :class:`PSpec`, from
  :func:`tree_shardings`) gives this rank's slice of a full tensor
  (``local``) and reassembles a full tensor from the ranks' slices
  (``gather``: a functional all-gather over the axes each dim names), the
  counterpart of ``jax.sharding.NamedSharding`` for the checkpointer and
  the trainer;
* :class:`activation_sharding` / :func:`sharded_trace` put a mesh in
  context for the model code: :func:`data_shard_count` is then the product
  of its data axes (the MoE's dispatch groups), :func:`data_context`
  hands the model the data group for the loss's and the MoE's
  collectives, and :func:`model_context` the model group, over which
  every family runs tensor-parallel (``models/tp.py``: each rank holds
  the block of every leaf that :func:`logical_pspec` gives it, and the
  layers compute Megatron-style where the rules' split is a Megatron
  split).  :func:`shard_activation` is the identity on every mesh: an
  activation's layout is whatever the tensor-parallel layers produce.
  Rules that give ``"seq"`` the model axis (``SEQ_PARALLEL_RULES``, which
  :func:`auto_rules` picks where the heads do not divide the axis) make
  the layers sequence-parallel: :func:`residual_seq_split` reads
  :func:`logical_pspec` on the residual's ``("batch", "seq",
  "act_embed")`` as JAX's ``_shard_act`` does, and where it splits ``seq``
  each model rank holds its block of S/M rows between blocks
  (``models.tp.TP.for_seq``).

Per-leaf ZeRO over the data axes (``zero_pspec``, the JAX trainer's
``fsdp_params=True`` layout): each data rank holds one block of a param
leaf's model block, split on the first free dim the data axes divide;
``models.tp.ZeroGather`` gathers a layer's blocks over the data group when the
model reads them, and its backward leaves each rank the summed gradient
of its own blocks.
"""
from __future__ import annotations

import contextvars
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


# ---------------------------------------------------------------------------
# activation context: the mesh the model code runs under
# ---------------------------------------------------------------------------
_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_activation_sharding", default=None)

#: the families that run tensor-parallel over a model axis larger than 1:
#: all six
TP_FAMILIES = ("dense", "ssm", "hybrid", "moe", "audio", "vlm")


def model_axis_waits(family: str, model: int) -> str:
    """Why a family is refused on a model axis of ``model``."""
    return (f"the {family!r} family on a model axis of {model}: tensor "
            f"parallelism runs the families {TP_FAMILIES} only (use a "
            "data-only mesh, model = 1)")


def check_model_axis(cfg, mesh, rules=None) -> None:
    """Raise ``NotImplementedError`` when ``mesh``'s model axis is larger
    than 1 and ``cfg``'s family does not run tensor-parallel (every family
    of the registry does)."""
    rules = rules or DEFAULT_RULES
    model = _mesh_size(mesh, rules.model_axis) if mesh is not None else 1
    if model > 1 and cfg.family not in TP_FAMILIES:
        raise NotImplementedError(model_axis_waits(cfg.family, model))


class activation_sharding:
    """Context manager putting ``mesh`` (a bound mesh) and ``rules`` in
    context for the model code; outside it (one device, no mesh) every
    helper below is inert."""

    def __init__(self, mesh, rules=None):
        self.mesh = mesh
        self.rules = rules or DEFAULT_RULES

    def __enter__(self):
        self._tok = _ACT_CTX.set((self.mesh, self.rules))
        return self

    def __exit__(self, *exc):
        _ACT_CTX.reset(self._tok)
        return False


def bound_to_context(fn):
    """``fn`` bound to the activation context active now, for work that
    runs later on another thread (a block recomputed in a CUDA backward
    runs on autograd's thread, where the context variable is unset)."""
    ctx = _ACT_CTX.get()

    def run(*a, **k):
        tok = _ACT_CTX.set(ctx)
        try:
            return fn(*a, **k)
        finally:
            _ACT_CTX.reset(tok)
    return run


def sharded_trace(fn, mesh, rules=None):
    """Wrap a step function so the activation context holds while it
    runs."""
    def wrapped(*a, **k):
        with activation_sharding(mesh, rules):
            return fn(*a, **k)
    return wrapped


def shard_activation(x, axes):
    """The activation constraint of the JAX package: the identity, in a
    context or not.  Each rank holds its batch rows, and over the model
    axis the tensor-parallel layers produce their own layout."""
    return x


def data_shard_count() -> int:
    """Number of data-parallel shards in the active activation context
    (1 outside any context): the MoE's dispatch groups."""
    ctx = _ACT_CTX.get()
    if ctx is None:
        return 1
    mesh, rules = ctx
    return math.prod(_mesh_size(mesh, a) for a in rules.data_axes)


def data_context():
    """``(process group, shards, this rank's shard)`` of the active
    context's data axes flattened, or None outside a context.  The model
    code reduces over the group what JAX reduces over the global batch."""
    ctx = _ACT_CTX.get()
    if ctx is None:
        return None
    mesh, rules = ctx
    axes = pool_axes(mesh, rules)
    return mesh.group(axes), mesh.count(axes), mesh.my_index(axes)


def model_axis_size() -> int:
    """The active context's model axis size (1 outside any context)."""
    ctx = _ACT_CTX.get()
    return 1 if ctx is None else _mesh_size(ctx[0], ctx[1].model_axis)


def model_context():
    """``(process group, size, this rank's index)`` of the active context's
    model axis (a bound mesh), or None outside a context and on a model
    axis of 1."""
    n = model_axis_size()
    if n == 1:
        return None
    mesh, rules = _ACT_CTX.get()
    axes = (rules.model_axis,)
    return mesh.group(axes), n, mesh.my_index(axes)


def active_rules():
    """The rules of the active context (``DEFAULT_RULES`` outside one)."""
    ctx = _ACT_CTX.get()
    return DEFAULT_RULES if ctx is None else ctx[1]


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


#: the residual stream's logical axes (JAX ``_shard_act`` on a rank-3
#: activation)
RESIDUAL_AXES = ("batch", "seq", "act_embed")


def residual_seq_split(mesh, rules: Rules, S: int, d_model: int = 1) -> bool:
    """Whether ``rules`` split the residual stream of ``S`` rows (width
    ``d_model``) on ``seq`` over ``mesh``'s model axis: the model axis
    larger than 1, ``seq`` named by the rules, S a multiple of it and at
    least it, and no dim of higher priority taking it first."""
    ps = logical_pspec(RESIDUAL_AXES, (1, S, d_model), mesh, rules)
    return ps[1] == rules.model_axis


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


class NamedSharding:
    """A tensor's layout over a mesh: ``spec`` names, per dim, the mesh
    axes that dim is split over (row-major over the named axes, as JAX
    splits it).  ``local`` takes a rank's block of a full tensor;
    ``gather`` (on a bound mesh) reassembles the full tensor from every
    rank's block, one functional all-gather per split dim."""

    def __init__(self, mesh, spec: PSpec):
        self.mesh = mesh
        self.spec = spec

    def _split(self, ndim: int) -> list:
        entries = list(self.spec) + [None] * (ndim - len(self.spec))
        return [() if e is None else (e if isinstance(e, tuple) else (e,))
                for e in entries]

    def shard_shape(self, shape) -> tuple:
        """One rank's block shape of a tensor of ``shape``."""
        out = []
        for n, axes in zip(shape, self._split(len(shape))):
            k = self.mesh.count(axes)
            if n % k:
                raise ValueError(f"{self.spec} splits a dim of {n} into "
                                 f"{k} blocks")
            out.append(n // k)
        return tuple(out)

    def local(self, full, rank=None):
        """The block of ``full`` (a tensor or a numpy array) that ``rank``
        holds (this process's rank on a bound mesh by default): a view, by
        basic slicing."""
        coords = self.mesh.coords if rank is None \
            else self.mesh.coords_of(rank)
        shape = self.shard_shape(full.shape)
        idx = tuple(
            slice(None) if not axes else slice(
                self.mesh.index(axes, coords) * n,
                (self.mesh.index(axes, coords) + 1) * n)
            for n, axes in zip(shape, self._split(len(full.shape))))
        return full[idx]

    def gather(self, t):
        """The full tensor from every rank's block ``t`` (this rank's)."""
        from .collectives import all_gather

        for d, axes in enumerate(self._split(t.dim())):
            if self.mesh.count(axes) > 1:
                t = all_gather(t, self.mesh.group(axes), dim=d)
        return t

    def stacked(self) -> "NamedSharding":
        """The sharding of a stack of such tensors (a new leading dim,
        whole on every rank: the grid lane's ``(n_grid, ...)`` states)."""
        return NamedSharding(self.mesh, PSpec(None, *self.spec))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def tree_shardings(spec_tree, mesh, rules: Rules = DEFAULT_RULES,
                   zero: bool = False):
    """Map a Spec tree → a :class:`NamedSharding` tree of the same paths."""
    return tree_map(lambda p: NamedSharding(mesh, p),
                    tree_pspecs(spec_tree, mesh, rules, zero))


def local_specs(spec_tree, shardings):
    """The Specs of one rank's blocks of a Spec tree: each leaf's shape its
    ``shardings`` leaf's ``shard_shape``."""
    return tree_map(lambda s, sh: dataclasses.replace(
        s, shape=sh.shard_shape(s.shape)), spec_tree, shardings)


def _axes_of(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple)
                                     else (entry,))


def data_dim(spec: PSpec, mesh, rules: Rules = DEFAULT_RULES):
    """The dim of ``spec`` split over the data axes into more than one
    block (per-leaf ZeRO's dim), or None."""
    data = set(rules.data_axes)
    for i, e in enumerate(spec):
        axes = _axes_of(e)
        if axes and set(axes) <= data and mesh.count(axes) > 1:
            return i
    return None


def split_axes(spec: PSpec, mesh, rules: Rules = DEFAULT_RULES) -> str:
    """Which groups a leaf of ``spec`` is split over, counting only groups
    of more than one rank: ``""``, ``"data"``, ``"model"`` or
    ``"data+model"`` (``optim.global_norm``'s classes)."""
    model = any(rules.model_axis in _axes_of(e) for e in spec) and \
        _mesh_size(mesh, rules.model_axis) > 1
    data = data_dim(spec, mesh, rules) is not None
    return "+".join(n for n, on in (("data", data), ("model", model)) if on)

