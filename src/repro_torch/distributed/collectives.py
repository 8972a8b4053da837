"""The data-parallel trainer's collectives: functional, counted.

Every collective of the port goes through this module and through
``torch.distributed._functional_collectives``, whose ops dispatch as
``_c10d_functional.*``: the cost tally of ``launch/op_cost.py`` sees them
(it counts each one's operand bytes), where the in-place ``dist.*`` calls
would dispatch as ``c10d.*`` and be missed.  The three names used here
exist in torch 2.11 and 2.13 alike.

``launches`` and ``nbytes`` count each kind's calls and operand bytes
since the counters were last set (:func:`reset`), as the kernels'
``launches`` do: the backend reports a round's collectives from them.

A collective runs on whatever device its tensor lies on, through the
group's backend (NCCL for CUDA tensors, gloo for CPU tensors); nothing
here copies a tensor to the host or picks another backend.
"""
from __future__ import annotations

import warnings

import torch

KINDS = ("all_reduce", "all_gather", "reduce_scatter")

#: calls and operand bytes by kind since :func:`reset`
launches = dict.fromkeys(KINDS, 0)
nbytes = dict.fromkeys(KINDS, 0)


def reset() -> None:
    for k in KINDS:
        launches[k] = 0
        nbytes[k] = 0


def snapshot() -> dict:
    """``{kind: [calls, bytes]}`` now, to subtract from a later one."""
    return {k: [launches[k], nbytes[k]] for k in KINDS}


def since(before: dict) -> dict:
    """``{kind: [calls, bytes]}`` since ``before`` (:func:`snapshot`)."""
    return {k: [launches[k] - before[k][0], nbytes[k] - before[k][1]]
            for k in KINDS}


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


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` of ``t`` (a new tensor; ``t`` is not changed)."""
    _note("all_reduce", t)
    return _call("all_reduce", t.contiguous(), "sum", group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group order."""
    _note("all_gather", t)
    return _call("all_gather_tensor", t.contiguous(), dim, group)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Σ over ``group`` of ``t``, of which this rank keeps its block along
    ``dim`` (its group position's)."""
    _note("reduce_scatter", t)
    return _call("reduce_scatter_tensor", t.contiguous(), "sum", dim,
                 group)


class _GatherRows(torch.autograd.Function):
    """all-gather along dim 0; the backward reduce-scatters the gradient
    (every rank's contribution to this rank's rows, summed)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather(t, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group), None


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_gather` along dim 0, differentiable: the gradient of a
    loss summed over the ranks reaches each rank's own rows."""
    return _GatherRows.apply(t, group)
