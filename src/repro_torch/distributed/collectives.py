"""The port's collectives, functional and counted: the data-parallel
trainer's, and the tensor-parallel operators over the mesh's model axis.

Every collective of the port goes through this module and through
``torch.distributed._functional_collectives``, whose ops dispatch as
``_c10d_functional.*``: the cost tally of ``launch/op_cost.py`` sees them
(it counts each one's operand bytes), where the in-place ``dist.*`` calls
would dispatch as ``c10d.*`` and be missed.  The three names used here
exist in torch 2.11 and 2.13 alike.

``launches`` and ``nbytes`` count each kind's calls and operand bytes
since the counters were last set (:func:`reset`), as the kernels'
``launches`` do: the backend reports a round's collectives from them.
``seq_launches`` counts the sequence-parallel operators
(:func:`gather_seq`, :func:`scatter_seq`) by name, forward calls only;
their collectives, forward and backward, count under ``launches`` too.

A collective runs on whatever device its tensor lies on, through the
group's backend (NCCL for CUDA tensors, gloo for CPU tensors); nothing
here copies a tensor to the host or picks another backend.  Over a
:class:`TracedGroup` (``launch.mesh.TracedMesh``: one rank of a mesh
traced with no process group, as the dry-run traces the production
meshes on ``meta``) a collective returns its output's shape and counts
its operand bytes in the active ``launch/op_cost.py`` tally.  Over a
:class:`LocalGroup` (``models.tp.ThreadRanks``: ranks as threads of one
process) the group combines the ranks' tensors itself, and nothing is
counted.
"""
from __future__ import annotations

import functools
import warnings

import torch

KINDS = ("all_reduce", "all_gather", "reduce_scatter")

SEQ_KINDS = ("gather_seq", "scatter_seq")

#: calls and operand bytes by kind since :func:`reset`
launches = dict.fromkeys(KINDS, 0)
nbytes = dict.fromkeys(KINDS, 0)
#: forward calls of the sequence-parallel operators since :func:`reset`
seq_launches = dict.fromkeys(SEQ_KINDS, 0)


def reset() -> None:
    for k in KINDS:
        launches[k] = 0
        nbytes[k] = 0
    for k in SEQ_KINDS:
        seq_launches[k] = 0


def snapshot() -> dict:
    """``{kind: [calls, bytes]}`` now, to subtract from a later one."""
    return {k: [launches[k], nbytes[k]] for k in KINDS}


def since(before: dict) -> dict:
    """``{kind: [calls, bytes]}`` since ``before`` (:func:`snapshot`)."""
    return {k: [launches[k] - before[k][0], nbytes[k] - before[k][1]]
            for k in KINDS}


class TracedGroup:
    """A stand-in for the process group of ``size`` ranks along some mesh
    axes, bound to no process: a collective over it returns a tensor of
    its output's shape and dtype on the operand's device (the operand
    itself, repeated or its first block: the values mean nothing off
    ``meta``), counted as the collective
    (``launch.op_cost.stand_in_collective``)."""

    def __init__(self, size: int):
        self.size = size

    def __repr__(self):
        return f"TracedGroup({self.size})"


class LocalGroup:
    """Rank ``rank`` of ``size`` ranks that are threads of this process
    (``models.tp.ThreadRanks``): ``combine(rank, t, how)`` hands in this
    rank's ``t`` and returns ``how`` of every rank's (a list in rank
    order) once all have handed theirs in.  A collective over it combines
    the ranks' tensors as the collective would: a sum in rank order, a
    max, a concatenation, a sum of which the rank keeps its block."""

    def __init__(self, combine, size: int, rank: int):
        self.combine, self.size, self.rank = combine, size, rank

    def collective(self, kind: str, t: torch.Tensor, dim: int = 0,
                   op: str = "sum") -> torch.Tensor:
        if kind == "all_gather":
            return self.combine(self.rank, t, lambda ts: torch.cat(ts, dim))
        fold = torch.maximum if op == "max" else torch.add
        out = self.combine(self.rank, t, lambda ts: functools.reduce(fold,
                                                                     ts))
        if kind == "reduce_scatter":
            n = out.shape[dim] // self.size
            out = out.narrow(dim, self.rank * n, n).clone()
        return out


def _note(kind: str, t: torch.Tensor) -> None:
    launches[kind] += 1
    nbytes[kind] += t.numel() * t.element_size()


def _funcol():
    import torch.distributed._functional_collectives as funcol
    return funcol


def _call(name: str, *args) -> torch.Tensor:
    """``funcol.<name>(*args)``, waited on.  torch 2.13 marks the gather
    and scatter names deprecated in favour of names that 2.11 may lack;
    the warning is dropped here, where the choice was made."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        out = getattr(_funcol(), name)(*args)
    return _funcol().wait_tensor(out)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Σ (or the ``op``, ``"max"``) over ``group`` of ``t`` (a new tensor;
    ``t`` is not changed)."""
    if isinstance(group, LocalGroup):
        return group.collective("all_reduce", t, 0, op)
    _note("all_reduce", t)
    if isinstance(group, TracedGroup):
        return _stand_in("all_reduce", t, group)
    return _call("all_reduce", t.contiguous(), op, group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group order."""
    if isinstance(group, LocalGroup):
        return group.collective("all_gather", t, dim)
    _note("all_gather", t)
    if isinstance(group, TracedGroup):
        return _stand_in("all_gather", t, group, dim)
    return _call("all_gather_tensor", t.contiguous(), dim, group)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Σ over ``group`` of ``t``, of which this rank keeps its block along
    ``dim`` (its group position's)."""
    if isinstance(group, LocalGroup):
        return group.collective("reduce_scatter", t, dim)
    _note("reduce_scatter", t)
    if isinstance(group, TracedGroup):
        return _stand_in("reduce_scatter", t, group, dim)
    return _call("reduce_scatter_tensor", t.contiguous(), "sum", dim,
                 group)


def _stand_in(kind: str, t: torch.Tensor, group: TracedGroup,
              dim: int = 0) -> torch.Tensor:
    from ..launch.op_cost import stand_in_collective
    return stand_in_collective(kind, t.contiguous(), group.size, dim)


class _GatherBlocks(torch.autograd.Function):
    """all-gather along ``dim``; the backward reduce-scatters the gradient
    along it, in the gradient's dtype (every rank's contribution to this
    rank's block, summed)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


def gather_blocks(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """:func:`all_gather` along ``dim``, differentiable: the gradient of a
    loss summed over the ranks reaches each rank's own block (per-leaf
    ZeRO's gather on use, ``models.tp.ZeroGather``)."""
    return _GatherBlocks.apply(t, group, dim)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`gather_blocks` along dim 0: each rank's rows."""
    return _GatherBlocks.apply(t, group, 0)


# ---------------------------------------------------------------------------
# tensor parallelism over the model axis (Megatron's f and g operators)
#
# Every model rank holds the same replicated activations and the loss is
# the same on each, so a leaf's gradient is what the rank's own backward
# gives, once these operators sit where replicated compute meets
# rank-partial compute (each rank's heads, ff columns, experts or vocab
# rows):
#
# * copy-to-model on every tensor entering a rank-partial region (the
#   normed input of a column-parallel projection, the routing weights
#   entering the rank's experts, a replicated leaf read there such as a
#   QK-norm weight): identity forward, all-reduce backward, since each
#   rank's region gives only its part of that tensor's gradient;
# * reduce-from-model on a rank-partial output (a row-parallel projection,
#   the experts' combine, the vocab-parallel lookups and sums):
#   all-reduce forward, identity backward;
# * gather-from-model on a leaf that the rules split on a dim no layer
#   computes on in parallel (a norm weight on ``embed``, the router on
#   ``experts``, qwen2's attention at a model axis that its 14 heads do
#   not divide): all-gather forward.  Its backward depends on the
#   consumer.  Compute that every rank repeats identically gives each
#   rank the whole gradient, so the backward keeps the rank's block
#   (``partial=False``); a reduce-scatter there would multiply the
#   gradient by the model axis.  Rank-partial compute (a gathered key
#   projection whose heads each rank reads only in part) gives each rank
#   a part, so the backward reduce-scatters (``partial=True``).
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, partial, rank):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        ctx.rank, ctx.n = rank, t.shape[dim]
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None, \
                None
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, \
            None, None


def copy_to_model(t: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward all-reduces the gradient over
    ``group`` (a tensor entering a rank-partial region)."""
    return _CopyToModel.apply(t, group)


def reduce_from_model(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` forward; identity backward (a rank-partial
    output)."""
    return _ReduceFromModel.apply(t, group)


def gather_from_model(t: torch.Tensor, group, dim: int, rank: int,
                      partial: bool = False) -> torch.Tensor:
    """The ranks' blocks of a leaf concatenated along ``dim``; the backward
    keeps block ``rank`` of the gradient, or reduce-scatters it when the
    consumer is rank-partial (``partial``)."""
    return _GatherFromModel.apply(t, group, dim, partial, rank)


# ---------------------------------------------------------------------------
# sequence parallelism over the model axis (Megatron's sequence-parallel
# g and ḡ)
#
# Between blocks each model rank holds its block of the sequence's rows
# (the residual split on ``seq``).  Where a block runs on the rank's
# heads, ff columns, experts, SSM heads or vocabulary block, gather-seq
# takes the place of copy-to-model before it and scatter-seq the place of
# reduce-from-model after it; norms and token-wise compute run on the
# rank's rows.  The rule for the gradient of a gathered sequence is the
# one of ``gather_from_model``: a rank-partial consumer (each rank's heads
# reading every row) gives each rank a part of it, which the backward
# reduce-scatters; a consumer every rank repeats identically (a
# replicated region, as the MoE's routing) gives each rank the whole
# gradient, so the backward keeps the rank's rows.  A replicated region's
# whole output returns to the rank's rows through split-seq, whose
# backward all-gathers the rows' gradients.
# ---------------------------------------------------------------------------

class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, rank, M):
        ctx.group, ctx.dim = group, dim
        n = t.shape[dim] // M
        return t.narrow(dim, rank * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None, None, None


def gather_seq(t: torch.Tensor, group, dim: int, rank: int,
               partial: bool = True) -> torch.Tensor:
    """The ranks' blocks of rows concatenated along the sequence dim
    ``dim``: an all-gather whose backward reduce-scatters the gradient
    (``partial``, a rank-partial consumer) or keeps the rank's rows of it
    (a replicated consumer)."""
    if not isinstance(group, LocalGroup):
        seq_launches["gather_seq"] += 1
    return _GatherFromModel.apply(t, group, dim, partial, rank)


def scatter_seq(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Σ over the ranks of their parts ``t`` of a whole sequence, of which
    the rank keeps its block of rows along ``dim``: a reduce-scatter whose
    backward all-gathers the rows' gradients."""
    if not isinstance(group, LocalGroup):
        seq_launches["scatter_seq"] += 1
    return _ScatterSeq.apply(t, group, dim)


def split_seq(t: torch.Tensor, group, dim: int, rank: int,
              M: int) -> torch.Tensor:
    """The rank's block of rows of a whole sequence ``t`` that every rank
    holds the same (no collective forward); the backward all-gathers the
    rows' gradients, so every rank gets the whole gradient."""
    return _SplitSeq.apply(t, group, dim, rank, M)
