"""Declarative parameter specs (shape, logical axes, init law, dtype).

Counterpart of ``repro/models/specs.py``.  Every parameter is declared once
as a :class:`Spec`; ``init_tree`` materialises a nested dict of tensors with
the same paths as the JAX tree.  The logical axes are what the sharding
rules read (``distributed.sharding``): with ``shardings`` a tree holds a
rank's block of every leaf.

Random streams: each leaf draws from its own ``torch.Generator`` seeded
from ``(seed, crc32(path))`` (see :func:`leaf_seed`), so a leaf's values do
not depend on the traversal order.  A leaf draws on the CPU, whatever its
target device, unless it has more than ``DEVICE_DRAW_MIN`` elements and its
target is a card: then it draws on the card (:func:`materialize_on`), one
slice along its first axis after another from one CUDA generator, since a
full-width MoE's expert stack (5.2 billion elements) would otherwise take
minutes of host time and tens of GB of host f32.  Every leaf of a reduced
config, and every leaf of qwen2-0.5b and mamba2-370m at full width, lies
below that size, so their values do not depend on the target device.  These
streams are the port's own: they do not reproduce JAX's threefry draws.
Tests that compare the two packages carry weights across with
``models.convert``.
"""
from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32}
#: leaves with more elements than this draw on their target card
DEVICE_DRAW_MIN = 1 << 28


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple
    axes: tuple                    # logical axis names (or None), len == ndim
    init: str = "normal"           # normal | zeros | ones | embed | fan_in | mamba_A | mamba_dt
    dtype: str = "bfloat16"
    scale: float = 1.0             # multiplier on the init stddev

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _fan_in(shape, axes):
    """Contraction fan-in: everything that is not an obvious output axis."""
    if len(shape) == 1:
        return shape[0]
    return int(np.prod(shape[:-1])) if len(shape) == 2 else int(shape[0] * (shape[1] if len(shape) > 2 else 1))


def materialize(spec: Spec, gen: torch.Generator,
                device="cpu") -> torch.Tensor:
    """One leaf, drawn in f32 on the CPU from ``gen``, cast, then moved."""
    dt = torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "mamba_A":          # A_log with A ∈ [1, 16]
        a = torch.rand(spec.shape, generator=gen) * 15.0 + 1.0
        return torch.log(a).to(dt).to(device)
    if spec.init == "mamba_dt":         # dt bias: softplus^{-1} of dt ∈ [1e-3, 1e-1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt0 = torch.exp(torch.rand(spec.shape, generator=gen) * (hi - lo) + lo)
        return (dt0 + torch.log(-torch.expm1(-dt0))).to(dt).to(device)
    x = torch.randn(spec.shape, generator=gen) * _std(spec)
    return x.to(dt).to(device)


def _std(spec: Spec) -> float:
    if spec.init == "embed":
        std = 1.0
    elif spec.init == "fan_in":
        std = 1.0 / math.sqrt(max(_fan_in(spec.shape, spec.axes), 1))
    else:  # "normal"
        std = 0.02
    return std * spec.scale


def materialize_on(spec: Spec, seed: int, device) -> torch.Tensor:
    """One normal-law leaf drawn on ``device`` (a card): f32 normals from
    one ``torch.Generator(device)`` seeded with ``seed``, one slice along
    the first axis after another, each scaled and cast into the leaf."""
    gen = torch.Generator(device).manual_seed(seed)
    out = torch.empty(spec.shape, dtype=torch_dtype(spec.dtype), device=device)
    std = _std(spec)
    for i in range(spec.shape[0]):
        out[i] = torch.randn(spec.shape[1:], generator=gen,
                             device=device) * std
    return out


def _leaves(tree, prefix=""):
    """(keystr path, Spec) pairs in insertion order; paths are spelled as
    JAX's ``keystr`` spells them (``"['blocks']['attn']['wq']"``)."""
    for k, v in tree.items():
        path = f"{prefix}[{k!r}]"
        if isinstance(v, Spec):
            yield path, v
        else:
            yield from _leaves(v, path)


def leaf_seed(seed: int, path: str) -> int:
    """32-bit seed mixed from ``(seed, crc32(path))``: the CPU generator's
    Mersenne Twister keeps only the low 32 bits of what it is seeded with."""
    words = [int(seed) & 0xFFFFFFFF, zlib.crc32(path.encode())]
    return int(np.random.SeedSequence(words).generate_state(1)[0])


def init_tree(specs: dict, seed: int, device="cpu", shardings=None) -> dict:
    """Materialise a nested dict of Specs; leaf streams are keyed by path.
    With ``shardings`` (a matching tree of ``distributed.sharding.
    NamedSharding``) each leaf is drawn whole and this rank's block of it
    kept (a copy), so a rank's blocks are those of the whole tree."""
    def draw(v, path):
        if (torch.device(device).type == "cuda"
                and v.init in ("normal", "fan_in", "embed")
                and math.prod(v.shape) > DEVICE_DRAW_MIN):
            return materialize_on(v, leaf_seed(seed, path), device)
        gen = torch.Generator().manual_seed(leaf_seed(seed, path))
        return materialize(v, gen, device)

    def build(tree, sh, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}[{k!r}]"
            if isinstance(v, Spec):
                out[k] = draw(v, path)
                if sh is not None:
                    out[k] = sh[k].local(out[k]).clone(
                        memory_format=torch.contiguous_format)
            else:
                out[k] = build(v, None if sh is None else sh[k], path)
        return out
    return build(specs, shardings, "")


def meta_tree(specs):
    """A tree of ``meta`` tensors of the Specs' shapes and dtypes, with the
    same paths (the counterpart of JAX's ``abstract_tree``): stand-ins a
    step can be traced on with nothing allocated on any device."""
    if isinstance(specs, Spec):
        return torch.empty(specs.shape, dtype=torch_dtype(specs.dtype),
                           device="meta")
    return {k: meta_tree(v) for k, v in specs.items()}


def count_params(specs: dict) -> int:
    return sum(int(np.prod(s.shape)) for _, s in _leaves(specs))
