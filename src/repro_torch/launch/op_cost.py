"""Op-level cost of one traced step: the counterpart of ``hlo_cost.py``.

PyTorch has no HLO and no SPMD partitioner, so the port's cost model is a
trace of its own step: :func:`analyze` runs the step under a dispatch mode
that tallies every aten op it issues.  On ``meta`` tensors the trace
allocates nothing and computes nothing (the dry-run's stand-in for
lowering); on the card it tallies the step that really runs, so the two
counts can be held to each other.  :class:`Cost` keeps ``hlo_cost``'s keys:

* ``dot_flops`` — the products, from ``torch.utils.flop_counter``'s formula
  table (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution`` and its
  backward, ...), plus each kernel's own formula;
* ``hbm_bytes`` — operand plus result bytes of every op, each distinct
  tensor once per op (an in-place op's result is its operand; a broadcast,
  stride-0 dim counts its elements once), skipping
  view, alias and metadata ops (those whose schema makes the result a view
  of an input: ``view``, ``reshape``, ``expand``, ``t``, ``transpose``,
  ``permute``, ``as_strided``, ``slice``, ``select``, ``squeeze``,
  ``unsqueeze``, ``detach``, ``alias``, ...; and ``_unsafe_view``) and pure
  allocations (``empty*``, ``scalar_tensor``).  The port runs eagerly, so this is eager
  traffic: what its step moves, not what a fused program would;
* ``collective_bytes`` / ``collective_breakdown`` — operand bytes of the
  ``_c10d_functional`` collectives (0 on one card): the data-parallel
  trainer's and the tensor-parallel operators' (``distributed/
  collectives.py``; the all-reduce of a max included), those their
  backward passes run too.  A rank traced with no process group
  (``launch.mesh.TracedMesh``, the dry-run's production meshes) runs each
  collective as a stand-in (:func:`stand_in_collective`), counted as the
  ``_c10d_functional`` op itself is;
* ``n_while`` / ``unknown_trip_loops`` — 0: an eager trace unrolls every
  loop, so no trip count is guessed;

and adds ``peak_live_bytes``, the high-water mark of live storage bytes on
the traced device (the tensors alive when the trace starts, the arguments,
count from the start; a storage leaves when the last tensor on it dies),
the counterpart of XLA's ``memory_analysis``; ``kernels``, one row per
kernel with its launches, flops and bytes; and the top ops by bytes and by
flops.  An op that touches no tensor of the traced device (host work, such
as a checkpoint's copy of the CPU generator's state) is not counted.

**A kernel counts as one op.**  ``kernels/ops.py`` runs each kernel's
route through :func:`counted`: while a tally is active the route runs
inside :func:`kernel_region`, which adds the kernel's formula once
(:func:`flash_cost`, :func:`ssd_cost`, :func:`update_cost`; the same
formulas give ``chip_smoke.py``'s bounds) and suspends the tally of the
ops inside it (on ``meta`` and the CPU those are the plain version's), and
the region's outputs count as live.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .mesh import HBM_BW, PEAK_FLOPS_BF16

_aten = torch.ops.aten
#: not views by their schema, but move nothing: a reshape that shares its
#: input's storage, the allocations, a Python number made a 0-dim tensor
#: (made without an op on the CPU, by one on other devices) and a stream
#: record
_SKIP_TRAFFIC = {_aten._unsafe_view, _aten.empty, _aten.empty_like,
                 _aten.empty_strided, _aten.new_empty,
                 _aten.new_empty_strided, _aten.scalar_tensor,
                 _aten.record_stream}
#: ``_c10d_functional`` op → ``hlo_cost``'s collective name
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-broadcast"}


# ---------------------------------------------------------------------------
# the kernels' formulas: each input read once, each output written once
# ---------------------------------------------------------------------------

def visible_pairs(Sq: int, Sk: int, causal: bool, window,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the masks leave visible, keys from 0 and query
    row r at ``q_offset + r`` (causal ``kp <= qp``, window ``kp > qp −
    window``): the count of ``kernels.ref.attention_mask(Sq, Sk, causal,
    window, q_offset=q_offset)``, in O(Sq)."""
    qp = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qp, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window is not None else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_cost(q, k, causal=True, window=None, q_offset=0) -> tuple:
    """(flops, bytes) of one flash attention call: 2·D multiply-adds for
    QKᵀ and for PV on every visible (query, key) pair (a block of query
    rows from ``q_offset`` counts the pairs its rows really see); q, k, v
    read once and the output written once."""
    B, Sq, H, D = q.shape
    flops = 4 * D * visible_pairs(Sq, k.shape[1], causal, window,
                                  q_offset) * B * H
    return flops, 2 * (q.numel() + k.numel()) * q.element_size()


def ssd_cost(x, B_) -> tuple:
    """(flops, bytes) of one SSD chunk call: 2·c·c·N (C Bᵀ) + 2·c·c·P
    (scores · x·dt) + 2·c·N·P (the state) per (batch·chunk, head) cell, as
    the TPU kernel computes them; x, dt (f32), A (f32), B, C read once,
    y and the f32 states written once."""
    Bb, nc, c, H, P = x.shape
    N = B_.shape[-1]
    cells = Bb * nc * H
    nbytes = (2 * x.numel() * x.element_size() + Bb * nc * c * H * 4 + H * 4
              + 2 * B_.numel() * B_.element_size() + cells * N * P * 4)
    return 2 * cells * (c * c * N + c * c * P + c * N * P), nbytes


#: f32 operations per element of each update kernel (its Pallas body)
UPDATE_OPS = {"async_update": 2, "sgd_step": 2, "sgd_momentum_step": 4,
              "sgd_momentum_delayed": 4, "fused_adam": 18,
              "fused_adam_delayed": 18}
#: f32 moments each update kernel reads and writes
_MOMENTS = {"async_update": 0, "sgd_step": 0, "sgd_momentum_step": 1,
            "sgd_momentum_delayed": 1, "fused_adam": 2,
            "fused_adam_delayed": 2}
_SWAPS = ("async_update", "sgd_momentum_delayed", "fused_adam_delayed")


def update_bytes_per_elem(name: str, p_size: int, g_size: int) -> int:
    """Bytes one element moves through update kernel ``name`` with params
    of ``p_size`` and grads of ``g_size`` bytes: p read and written, each
    f32 moment read and written, the buffer read and written (the kernels
    that swap it), g read."""
    buf = 2 * g_size if name in _SWAPS else 0
    return 2 * p_size + 8 * _MOMENTS[name] + buf + g_size


def update_cost(name: str, p, g) -> tuple:
    """(f32 operations, bytes) of one launch of update kernel ``name``
    over ``p``'s elements."""
    n = p.numel()
    return (n * UPDATE_OPS[name],
            n * update_bytes_per_elem(name, p.element_size(),
                                      g.element_size()))


def bound_ms(flops, nbytes, peak_flops=PEAK_FLOPS_BF16) -> tuple:
    """(ms, "operations" | "bytes"): the least time the card could take,
    the larger of ``flops`` at ``peak_flops`` and ``nbytes`` at the HBM
    rate."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# the tally
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cost:
    """One traced step's counts (see the module docstring).  ``ops`` and
    ``kernels`` map a name to ``[calls, flops, bytes]``."""
    dot_flops: int = 0
    hbm_bytes: int = 0
    collective_bytes: int = 0
    collective_breakdown: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    peak_live_bytes: int = 0
    n_ops: int = 0
    ops: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)

    def top(self, by: str = "bytes", n: int = 8) -> list:
        """The ``n`` op names with the most ``by`` ("bytes" or "flops"),
        as ``[name, calls, flops, bytes]``."""
        col = {"flops": 1, "bytes": 2}[by]
        rows = sorted(self.ops.items(), key=lambda kv: -kv[1][col])[:n]
        return [[name, *row] for name, row in rows if row[col]]

    def as_dict(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_breakdown": dict(self.collective_breakdown),
            "n_while": 0,
            "unknown_trip_loops": 0,
            "argument_bytes": self.argument_bytes,
            "peak_live_bytes": self.peak_live_bytes,
            "n_ops": self.n_ops,
            "kernels": {k: {"launches": c, "flops": f, "bytes": b}
                        for k, (c, f, b) in self.kernels.items()},
            "top_bytes": self.top("bytes"),
            "top_flops": self.top("flops"),
        }


def _add(table: dict, name: str, flops: int, nbytes: int) -> None:
    row = table.setdefault(name, [0, 0, 0])
    row[0] += 1
    row[1] += flops
    row[2] += nbytes


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses: a broadcast (stride-0) dim
    reads its elements once, whatever its size."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


class _Tally(TorchDispatchMode):
    """The dispatch mode :func:`analyze` runs a step under.  The mode
    follows autograd's backward onto its device threads (it is part of
    the thread-local state the engine carries), so live-byte bookkeeping
    takes a lock."""

    def __init__(self, cost: Cost, device: torch.device):
        super().__init__()
        self.cost = cost
        self.device = device
        self._lock = threading.Lock()
        self._live: dict = {}          # storage id → [tensor refs, bytes]
        self._cur = 0
        self._suspended = 0

    # -- live bytes ----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until the last tracked tensor on
        it dies."""
        if t.device != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            ent = self._live.get(key)
            if ent is None:
                ent = self._live[key] = [0, st.nbytes()]
                self._cur += ent[1]
                self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                                self._cur)
            ent[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        with self._lock:
            ent = self._live[key]
            ent[0] -= 1
            if ent[0] == 0:
                self._cur -= ent[1]
                del self._live[key]

    def track_tree(self, tree) -> None:
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)

    # -- ops -----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not any(t.device == self.device for t in ins + outs):
            return out                   # host work: no device traffic
        for t in ins:                    # a tensor made before the trace
            if t.device == self.device and \
                    t.untyped_storage()._cdata not in self._live:
                self._track(t)
        for t in outs:
            self._track(t)
        self._count(func, args, kwargs, out, ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        packet = func._overloadpacket
        cost = self.cost
        formula = flop_registry.get(packet)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        nbytes = 0
        if not (func.is_view or packet in _SKIP_TRAFFIC):
            seen = set()
            for t in ins + outs:
                if id(t) not in seen:
                    seen.add(id(t))
                    nbytes += _nbytes(t)
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is None:             # wait_tensor: no traffic
                return
            coll = sum(_nbytes(t) for t in ins)
            cost.collective_bytes += coll
            cost.collective_breakdown[kind] = \
                cost.collective_breakdown.get(kind, 0) + coll
        cost.dot_flops += flops
        cost.hbm_bytes += nbytes
        cost.n_ops += 1
        _add(cost.ops, f"{func.namespace}.{packet.__name__}", flops, nbytes)


#: a stand-in collective's kind → the ``_c10d_functional`` op it counts as
_FUNCOL_OPS = {"all_reduce": "all_reduce",
               "all_gather": "all_gather_into_tensor",
               "reduce_scatter": "reduce_scatter_tensor"}


def stand_in_collective(kind: str, t: torch.Tensor, n: int,
                        dim: int = 0) -> torch.Tensor:
    """Collective ``kind`` of ``distributed.collectives`` over ``n`` ranks
    of the contiguous ``t``, with no process group: a new tensor of the
    output's shape (``t`` itself for an all-reduce, ``n`` copies along
    ``dim`` for an all-gather, its first ``1/n`` along ``dim`` for a
    reduce-scatter; only its shape means something), counted in the
    active tally as the ``_c10d_functional`` op: its operand's bytes under
    ``collective_bytes``, operand and result under ``hbm_bytes``.  The
    copy that makes the output is not counted."""
    tally = active()
    if tally is not None:
        tally._suspended += 1
    try:
        if kind == "all_reduce":
            out = t.clone()
        elif kind == "all_gather":
            out = torch.cat([t] * n, dim)
        else:
            out = t.narrow(dim, 0, t.shape[dim] // n).clone()
    finally:
        if tally is not None:
            tally._suspended -= 1
    if tally is not None and not tally._suspended:
        tally._track(out)
        cost = tally.cost
        coll = _nbytes(t)
        nbytes = coll + _nbytes(out)
        cost.collective_bytes += coll
        name = _COLLECTIVES[_FUNCOL_OPS[kind]]
        cost.collective_breakdown[name] = \
            cost.collective_breakdown.get(name, 0) + coll
        cost.hbm_bytes += nbytes
        cost.n_ops += 1
        _add(cost.ops, f"_c10d_functional.{_FUNCOL_OPS[kind]}", 0, nbytes)
    return out


def active():
    """The innermost tally of the current thread's dispatch mode stack, or
    None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _Tally):
            return mode
    return None


class _Region:
    def __init__(self):
        self.out = None

    def result(self, out):
        """Mark ``out`` as the region's outputs (live after it); returns
        ``out``."""
        self.out = out
        return out


@contextlib.contextmanager
def kernel_region(name: str, flops: int, nbytes: int, *,
                  products: bool = True):
    """One launch of kernel ``name``: adds ``flops`` (to ``dot_flops`` when
    ``products``: matrix products, not elementwise operations) and
    ``nbytes`` once to the active tally and suspends its count of the ops
    inside; what the region hands to ``result`` counts as live after it.
    Without an active tally it does nothing."""
    tally, region = active(), _Region()
    if tally is None:
        yield region
        return
    cost = tally.cost
    _add(cost.kernels, name, flops, nbytes)
    _add(cost.ops, f"kernel.{name}", flops if products else 0, nbytes)
    cost.dot_flops += flops if products else 0
    cost.hbm_bytes += nbytes
    cost.n_ops += 1
    tally._suspended += 1
    try:
        yield region
    finally:
        tally._suspended -= 1
    tally.track_tree(region.out)


def kernel_cost(name: str, *args, causal=True, window=None, q_offset=0,
                **_) -> tuple:
    """(flops, bytes, products) of one call of kernel ``name`` on the
    arguments of its ``kernels/ops.py`` entry point: flash and SSD count
    matrix products, the update kernels (p first, g just before the
    scalar block) f32 elementwise operations."""
    if name == "flash_attention":
        return (*flash_cost(args[0], args[1], causal, window, q_offset),
                True)
    if name == "ssd_chunk":
        return (*ssd_cost(args[0], args[3]), True)
    return (*update_cost(name, args[0], args[-2]), False)


def counted(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, as one launch of kernel ``name`` when a tally is
    active (:func:`kernel_cost`); a plain call otherwise, so the formula
    costs nothing outside a trace."""
    if active() is None:
        return fn(*args, **kw)
    flops, nbytes, products = kernel_cost(name, *args, **kw)
    with kernel_region(name, flops, nbytes, products=products) as region:
        return region.result(fn(*args, **kw))


def _device_of(tree) -> torch.device:
    """The first non-CPU device among the tensors of ``tree``, else the
    CPU."""
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor) and t.device.type != "cpu":
            return t.device
    return torch.device("cpu")


def analyze(fn, *args, device=None, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` under a tally → its :class:`Cost`.

    ``device`` is the traced device (default: the first non-CPU device of
    the arguments, else the CPU); live bytes count its storages only.  The
    arguments' tensors are live from the start (``argument_bytes``)."""
    cost = Cost()
    dev = torch.device(device) if device is not None \
        else _device_of((args, kwargs))
    tally = _Tally(cost, dev)
    tally.track_tree((args, kwargs))
    cost.argument_bytes = cost.peak_live_bytes = tally._cur
    with tally:
        fn(*args, **kwargs)
    return cost
