"""Checkpoints: a nested-dict state of tensors ↔ ``state.npz`` + ``meta.json``.

Counterpart of ``repro/checkpoint/checkpointer.py``, with the same files on
disk, so a checkpoint written by either package restores in the other:

* ``state.npz`` holds one array per leaf, keyed by the leaf's
  ``jax.tree_util.keystr`` path (``['params']['embed']``,
  :func:`repro_torch.tree.tree_leaves_with_path`); a bf16 leaf is stored
  as its ``uint16`` bits under the ``__bf16__`` prefix (npz has no bf16).
* ``meta.json`` holds ``step``, the sorted ``keys``, the state file's
  ``state_sha256`` and ``state_nbytes``, and the caller's meta.

A state split over data ranks (a ranked trainer's, with its
``state_shardings()``) saves as the JAX checkpointer saves the same state
on its mesh: each leaf gathered whole (a pooled m, v or gbuf as the
``(R, cols)`` pool), written by rank 0 alone, the ranks meeting at a
barrier after the write; :func:`restore` with ``shardings`` gives each rank
its rows of every split leaf.

Durability contract: :func:`save` is atomic at the file level — each file
is written to a temp file in the target directory and ``os.replace``-d
into place, the state first and the metadata last, so a crash mid-save
leaves at worst a fresh ``state.npz`` beside the previous ``meta.json``,
which :func:`verify` and :func:`restore` detect through the recorded
sha256 and refuse.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import zipfile

import numpy as np
import torch

from ..models.convert import _to_numpy
from ..tree import tree_leaves_with_path, tree_map, tree_map_with_path

_BF16 = "__bf16__"


class CheckpointError(RuntimeError):
    """A checkpoint is missing, partial, or corrupt — never restore from
    it silently."""


def _flatten(tree) -> dict:
    return {(_BF16 if leaf.dtype == torch.bfloat16 else "") + key:
            _to_numpy(leaf) for key, leaf in tree_leaves_with_path(tree)}


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _replace_into(path: str, name: str, write_fn) -> str:
    """Write via ``write_fn(tmp_path)``, then rename atomically to
    ``path/name`` (same directory, so the rename never crosses a
    filesystem)."""
    fd, tmp = tempfile.mkstemp(dir=path, prefix=f".{name}.", suffix=".tmp")
    os.close(fd)
    try:
        write_fn(tmp)
        os.replace(tmp, os.path.join(path, name))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return os.path.join(path, name)


def save(path: str, state, step: int | None = None,
         meta: dict | None = None, shardings=None) -> None:
    """Write ``state`` (a tree of tensors on any device) to the directory
    ``path``.  With ``shardings`` (a matching tree of
    ``distributed.sharding.NamedSharding``) every rank calls it: each leaf
    is gathered whole, rank 0 writes, and the ranks return together."""
    if shardings is None:
        _write(path, state, step, meta)
        return
    import torch.distributed as dist

    state = tree_map(lambda t, sh: sh.gather(t), state, shardings)
    if dist.get_rank() == 0:
        _write(path, state, step, meta)
    dist.barrier()


def _write(path: str, state, step, meta) -> None:
    os.makedirs(path, exist_ok=True)
    flat = _flatten(state)
    digest = {}

    def write_state(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        digest["sha"] = _sha256(tmp)
        digest["nbytes"] = os.path.getsize(tmp)

    # state first, meta last: meta.json names the state file's digest, so a
    # crash between the two renames leaves a detectable (sha-mismatched)
    # pair rather than a restorable-looking torn checkpoint
    _replace_into(path, "state.npz", write_state)
    info = {"step": int(step) if step is not None else None,
            "keys": sorted(flat),
            "state_sha256": digest["sha"],
            "state_nbytes": int(digest["nbytes"]),
            **(meta or {})}

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(info, f, indent=1)

    _replace_into(path, "meta.json", write_meta)


def verify(path: str) -> dict:
    """Integrity-check a checkpoint directory without loading the state;
    returns the metadata or raises :class:`CheckpointError` naming the
    defect (missing file, truncation, digest mismatch)."""
    meta_path = os.path.join(path, "meta.json")
    state_path = os.path.join(path, "state.npz")
    if not os.path.exists(meta_path):
        raise CheckpointError(f"{path}: meta.json is missing — not a "
                              "checkpoint, or save was interrupted")
    try:
        with open(meta_path) as f:
            info = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(f"{path}: meta.json is unreadable ({e}) — "
                              "corrupt checkpoint") from e
    if not os.path.exists(state_path):
        raise CheckpointError(f"{path}: state.npz is missing — corrupt or "
                              "partially deleted checkpoint")
    nbytes = info.get("state_nbytes")
    if nbytes is not None and os.path.getsize(state_path) != int(nbytes):
        raise CheckpointError(
            f"{path}: state.npz is {os.path.getsize(state_path)} bytes but "
            f"meta.json recorded {nbytes} — truncated or torn checkpoint")
    sha = info.get("state_sha256")
    if sha is not None and _sha256(state_path) != sha:
        raise CheckpointError(
            f"{path}: state.npz sha256 does not match meta.json — the "
            "state and metadata are from different saves (crash between "
            "the two atomic renames) or the file is corrupt")
    return info


def restore(path: str, like_state, shardings=None):
    """A tree shaped as ``like_state``, each leaf a new tensor on that
    leaf's device in its dtype (a stored leaf of another dtype is cast, as
    the JAX package casts).  With ``shardings`` (as in :func:`save`) the
    file holds whole leaves and each rank keeps its block of each
    (``like_state`` holds the blocks).  Shapes must match
    (``ValueError``); a missing, truncated or digest-mismatched
    checkpoint, or one without a leaf of ``like_state``, raises
    :class:`CheckpointError`."""
    verify(path)
    state_path = os.path.join(path, "state.npz")
    try:
        data = np.load(state_path)
        files = set(data.files)
    except (zipfile.BadZipFile, ValueError, OSError) as e:
        raise CheckpointError(
            f"{path}: state.npz failed to load ({e}) — corrupt "
            "checkpoint") from e

    shards = {} if shardings is None else dict(
        tree_leaves_with_path(shardings))

    def leaf(key, old):
        if _BF16 + key in files:
            t = torch.from_numpy(
                data[_BF16 + key].view(np.int16)).view(torch.bfloat16)
        elif key in files:
            t = torch.from_numpy(data[key])
        else:
            raise CheckpointError(
                f"{path}: leaf {key} is absent from the checkpoint — the "
                "saved state has a different structure")
        if key in shards:
            t = shards[key].local(t).clone(
                memory_format=torch.contiguous_format)
        if tuple(t.shape) != tuple(old.shape):
            raise ValueError(
                f"shape mismatch for {key}: {tuple(t.shape)} vs "
                f"{tuple(old.shape)}")
        return t.to(device=old.device, dtype=old.dtype)

    with data:
        return tree_map_with_path(leaf, like_state)


def load_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)
