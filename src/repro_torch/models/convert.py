"""Carry weights and trainer states between the port and numpy (and so the
JAX package), whole or as a rank's blocks (:func:`params_blocks`,
:func:`state_from_numpy` with shardings).

Trees are nested dicts keyed exactly as the JAX param tree.  bf16 leaves
cross as a ``uint16`` view of their bits, the way the JAX checkpointer
stores them, so round trips are bitwise.  On the way in, a ``uint16`` leaf
or a numpy array whose dtype is named ``bfloat16`` (what ``np.asarray``
gives for a JAX bf16 array) becomes a torch bf16 tensor; the param trees
hold no genuine 16-bit integers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                        # owned, writable, contiguous
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_to_numpy(params: dict) -> dict:
    """Tensors → numpy arrays (bf16 as its uint16 bits)."""
    return {k: params_to_numpy(v) if isinstance(v, dict) else _to_numpy(v)
            for k, v in params.items()}


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """numpy arrays (bf16 as uint16 bits or a ``bfloat16`` dtype) → tensors
    on ``device``."""
    dev = resolve_device(device)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else _from_numpy(v, dev)
                for k, v in t.items()}
    return build(tree)


_STATE_KEYS = {"params", "opt", "step"}


def _check_state(tree: dict) -> None:
    opt = set(tree.get("opt", ()))
    pooled = {"pools", "opt", "step"} <= set(tree) and "count" in opt
    if not pooled and (not _STATE_KEYS <= set(tree)
                       or not {"m", "v", "count"} <= opt):
        raise ValueError(f"not a trainer state: keys {sorted(tree)} (want "
                         "params, opt{m, v, count}, step and, when delayed, "
                         "gbuf; or pools, opt{count}, step)")


def state_to_numpy(state: dict) -> dict:
    """An ``AsyncTrainer`` state (params, opt.m/v/count, step, gbuf; or
    the pooled pools, opt.count, step) → numpy, bf16 leaves as uint16
    bits, int32 counters as int32."""
    _check_state(state)
    return params_to_numpy(state)


def state_from_numpy(tree: dict, device="cuda", shardings=None) -> dict:
    """numpy (for instance a JAX trainer state through ``np.asarray``) → an
    ``AsyncTrainer`` state on ``device``; round trips are bitwise.  With
    ``shardings`` (a ranked trainer's ``state_shardings()``) each leaf is
    this rank's block: a JAX pooled state's ``(R, cols)`` m, v and gbuf
    become rank r's row."""
    _check_state(tree)
    if shardings is not None:
        tree = _blocks(tree, shardings)
    return params_from_numpy(tree, device)


def params_blocks(tree: dict, shardings: dict, device="cuda") -> dict:
    """A rank's blocks of a whole param tree given as numpy (a JAX param
    tree through ``np.asarray``, bf16 as uint16 bits or a ``bfloat16``
    dtype): ``shardings`` is ``distributed.sharding.tree_shardings(
    param_specs(cfg), mesh, rules)`` on a bound mesh, each leaf's block
    is ``NamedSharding.local`` of the whole leaf, on ``device``."""
    return params_from_numpy(_blocks(tree, shardings), device)


def _blocks(tree: dict, shardings: dict) -> dict:
    return {k: _blocks(v, shardings[k]) if isinstance(v, dict)
            else np.array(shardings[k].local(np.asarray(v)))
            for k, v in tree.items()}
