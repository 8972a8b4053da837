"""Barrier-free durability: asynchronous snapshots of state updated in place.

Counterpart of ``repro/checkpoint/snapshot.py``.  The port's trainer and
slot server update their state in place, so a snapshot must be taken
before the next chunk overwrites it, without making the host wait for it:

1. ``offer(round, state)`` copies every leaf, on the current stream, into
   device buffers that belong to the snapshotter.  The copy is queued
   behind the chunk that produced the state and ahead of the next one, so
   it reads the state of the boundary however far the host runs ahead.
2. A side stream waits on an event recorded after that copy and fetches
   the copies into pinned host buffers with non-blocking copies, then
   records its own event.  The device and host buffers are allocated once
   per snapshotter (for a state of one structure) and reused two deep:
   while snapshot n is fetched, snapshot n − 1 is written to disk from
   the other pair.
3. The next ``offer`` (or ``drain``) waits on the fetch's event and writes
   the host arrays with :func:`repro_torch.checkpoint.save`, the ordinary
   atomic checkpoint.  By then the fetch has had a whole cadence to finish.

Over data ranks (``shardings``: a ranked trainer's ``state_shardings()``;
the plan executor sets it) every rank offers at the same boundaries:
each leaf is gathered whole there (a pooled m, v or gbuf from its rows),
rank 0 alone snapshots and writes the gathered state (the file the JAX
checkpointer writes for it), and :meth:`drain` ends in a barrier, so no
rank reads a snapshot rank 0 has yet to write.

On the CPU the copy is a plain ``clone``.  A SIGKILL at any point loses at
most the two pending snapshots; everything older is an atomically
written, sha-verified directory that :meth:`AsyncSnapshotter.latest` finds
and :func:`repro_torch.checkpoint.restore` loads.

A ``recorder`` (:class:`repro_torch.obs.Recorder`) gets a
``snapshot_copy`` span around the queued copies of each offer and a
``snapshot_finalise`` span (plus a ``snapshot_writes`` count) around each
write to disk, which lands a cadence after its offer; the executor adds
the ``snapshot_offer`` span around the whole offer.  They are host times:
the copy span measures how long the host takes to enqueue the copies.
"""
from __future__ import annotations

import os
import re
import shutil
from collections import deque
from contextlib import nullcontext
from typing import Optional

import torch

from ..tree import tree_leaves, tree_map
from . import checkpointer

_ROUND_DIR = re.compile(r"^round-(\d{8})$")


def _signature(tree) -> list:
    return [(tuple(t.shape), t.dtype, t.device) for t in tree_leaves(tree)]


class AsyncSnapshotter:
    """Periodic asynchronous snapshots of a run's state.

    ``every`` is the cadence in rounds (decode steps on the slot server): a
    chunk boundary ``hi`` is due when ``hi % every == 0``, and the final
    boundary always is.  Boundaries are the only offer points, so pick
    ``every`` as a multiple of the chunk length.  ``keep`` bounds disk:
    only the newest ``keep`` snapshot directories survive pruning.
    """

    def __init__(self, path: str, every: int, *, keep: int = 2,
                 meta: Optional[dict] = None, recorder=None,
                 shardings=None):
        if every < 1:
            raise ValueError(f"snapshot cadence must be >= 1 (got {every})")
        if keep < 1:
            raise ValueError(f"keep must be >= 1 (got {keep})")
        self.recorder = recorder            # repro_torch.obs.Recorder | None
        self.path = str(path)
        self.every = int(every)
        self.keep = int(keep)
        self._meta = dict(meta or {})
        self._pending: deque = deque()   # (round, host tree, event, meta)
        self._written: list = []         # (round, dirname), ascending
        self._buffers = [None, None]     # two (device, host) buffer pairs
        self._offers = 0
        self._side = None                # the fetch stream
        #: the state's shardings over data ranks, or None on one process
        self.shardings = shardings

    # ------------------------------------------------------------- schedule
    def due(self, round_i: int, total_rounds: int) -> bool:
        """Is the chunk boundary ``round_i`` a snapshot point?"""
        return round_i % self.every == 0 or round_i >= total_rounds

    # --------------------------------------------------------------- offers
    def _pair(self, state):
        """The (device, host) buffers for this offer: the pair the offer
        before last used, whose snapshot is already on disk."""
        i, sig = self._offers % 2, _signature(state)
        pair = self._buffers[i]
        if pair is None or pair[2] != sig:
            dev = tree_map(torch.empty_like, state)
            host = tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True), state)
            pair = self._buffers[i] = (dev, host, sig)
        return pair[0], pair[1]

    def offer(self, round_i: int, state, meta: Optional[dict] = None) -> None:
        """Snapshot ``state`` (a tree of tensors on one device) at round
        ``round_i`` without waiting for it.

        Queues the device copy and the host fetch and returns; the previous
        pending snapshot is written to disk on the way out, so at most one
        is in flight.  ``meta`` is merged into the saved ``meta.json`` (the
        slot server's host ledger rides there).  Over ranks every rank
        calls it; the leaves are gathered and rank 0 keeps the snapshot."""
        if self.shardings is not None:
            import torch.distributed as dist

            state = tree_map(lambda t, sh: sh.gather(t), state,
                             self.shardings)
            if dist.get_rank() != 0:
                self._offers += 1
                return
        device = tree_leaves(state)[0].device
        with self._span("snapshot_copy", round=int(round_i)):
            if device.type == "cuda":
                dev, host = self._pair(state)
                tree_map(lambda d, s: d.copy_(s), dev, state)
                copied = torch.cuda.Event()
                copied.record()
                if self._side is None:
                    self._side = torch.cuda.Stream(device)
                self._side.wait_event(copied)
                with torch.cuda.stream(self._side):
                    tree_map(lambda h, d: h.copy_(d, non_blocking=True),
                             host, dev)
                    fetched = torch.cuda.Event()
                    fetched.record()
                snap = host
            else:
                snap, fetched = tree_map(torch.clone, state), None
        self._offers += 1
        self._pending.append((int(round_i), snap, fetched, dict(meta or {})))
        while len(self._pending) > 1:
            self._write_oldest()

    def drain(self) -> Optional[int]:
        """Write every pending snapshot to disk (end of run); returns the
        newest written round, or None when nothing was ever offered."""
        while self._pending:
            self._write_oldest()
        if self.shardings is not None:
            import torch.distributed as dist
            dist.barrier()
        return self._written[-1][0] if self._written else None

    # ---------------------------------------------------------------- disk
    def round_dir(self, round_i: int) -> str:
        return os.path.join(self.path, f"round-{round_i:08d}")

    def _span(self, name: str, **args):
        rec = self.recorder
        return rec.span(name, "snapshot", **args) if rec is not None \
            else nullcontext()

    def _write_oldest(self) -> None:
        r, snap, fetched, extra = self._pending.popleft()
        meta = {**self._meta, **extra, "round": r, "kind": "snapshot"}
        # a cadence after the offer of the same round: the trace shows the
        # two-deep window overlapping the chunks in between
        with self._span("snapshot_finalise", round=r):
            if fetched is not None:
                fetched.synchronize()
            checkpointer.save(self.round_dir(r), snap, step=r, meta=meta)
        if self.recorder is not None:
            self.recorder.count("snapshot_writes")
        self._written.append((r, self.round_dir(r)))
        self._prune()

    def _prune(self) -> None:
        while len(self._written) > self.keep:
            _, old = self._written.pop(0)
            shutil.rmtree(old, ignore_errors=True)

    @staticmethod
    def latest(path: str) -> Optional[tuple]:
        """Newest restorable snapshot under ``path`` as ``(round,
        dirname)``, or None.  Directories that fail the checkpoint's
        integrity check (a save torn by the crash being recovered from)
        are skipped: that is why more than one is kept."""
        if not os.path.isdir(path):
            return None
        rounds = []
        for name in os.listdir(path):
            m = _ROUND_DIR.match(name)
            if m:
                rounds.append((int(m.group(1)), os.path.join(path, name)))
        for r, dirname in sorted(rounds, reverse=True):
            try:
                checkpointer.verify(dirname)
            except checkpointer.CheckpointError:
                continue
            return r, dirname
        return None
