"""Schedule → execution plan (host numpy, moved to the device by the executor).

Counterpart of ``repro/runtime/plan.py``.  :func:`compile_plan` lowers a
realised :class:`repro_torch.core.engine.Schedule` ONCE into a
:class:`RunPlan`: stacked per-round arrays (participation masks, delay
scales, per-round data keys) plus the static tables on-device batch
synthesis needs (the Zipf inverse-CDF and the per-group vocab permutations
of :class:`repro_torch.data.HeterogeneousTokenPipeline`).  Masks, delay
scales and tables are computed by the same numpy code as the JAX package's
and are array-equal to its plan.

The data keys are the port's own: round q's key is a pure function of
(seed, q) (:func:`round_keys`), so a run resumed at any round regenerates
the same stream.  It seeds a ``torch.Generator`` on the device; the batches
it draws are torch's stream, not JAX's threefry stream, so tests that
compare the two packages inject the JAX batches.

Not ported yet, and raising ``NotImplementedError``: the scenario channels
(``availability``, ``zipf_as``, ``grad_density``, ``fault_gain``);
ROADMAP.md lists them with the vmapped grid lane, which has no plan axis
here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import lower_rounds
from ..core.engine import Schedule


@dataclasses.dataclass(frozen=True)
class RunPlan:
    """Lowering of one training run.

    Per-round stacked arrays (row ``q`` drives round ``q``):

    * ``masks`` — ``(rounds, n_groups)`` f32 participation masks,
    * ``delay_scales`` — ``(rounds,)`` f32 per-round γ-scales (all ones
      unless the spec's stepsize policy is delay-adaptive),
    * ``data_keys`` — ``(rounds,)`` uint64 per-round generator seeds
      (:func:`round_keys`).

    Static data-synthesis tables: ``token_cdf`` ``(vocab,)`` f32 cumulative
    Zipf pmf and ``group_perms`` ``(n_groups, vocab)`` int32 group vocab
    permutations.
    """

    masks: np.ndarray
    delay_scales: np.ndarray
    data_keys: np.ndarray
    token_cdf: np.ndarray
    group_perms: np.ndarray
    global_batch: int
    seq_len: int
    seed: int
    adaptive: bool = False

    @property
    def rounds(self) -> int:
        return int(self.masks.shape[0])

    @property
    def n_groups(self) -> int:
        return int(self.masks.shape[1])

    @property
    def vocab(self) -> int:
        return int(self.token_cdf.shape[0])

    def __post_init__(self):
        if self.masks.shape[0] != self.delay_scales.shape[0] or \
                self.masks.shape[0] != self.data_keys.shape[0]:
            raise ValueError(
                f"per-round arrays disagree on rounds: masks "
                f"{self.masks.shape}, delay_scales {self.delay_scales.shape},"
                f" data_keys {self.data_keys.shape}")
        if self.group_perms.shape != (self.n_groups, self.vocab):
            raise ValueError(
                f"group_perms {self.group_perms.shape} != "
                f"(n_groups={self.n_groups}, vocab={self.vocab})")
        if self.global_batch % self.n_groups:
            raise ValueError(
                f"the {self.n_groups} groups must divide "
                f"global_batch={self.global_batch}")

    def summary(self) -> dict:
        """The JAX plan's summary keys, with the channels this port lacks
        at their stationary values."""
        return {"rounds": self.rounds, "n_groups": self.n_groups,
                "vocab": self.vocab, "global_batch": self.global_batch,
                "seq_len": self.seq_len, "seed": self.seed,
                "adaptive": self.adaptive, "n_grid": 0, "n_cdf_phases": 0,
                "sparsified": False, "faulted": False}


def round_keys(seed: int, rounds: int) -> np.ndarray:
    """``(rounds,)`` uint64: round q's generator seed, drawn from
    ``SeedSequence([seed, q])`` — a pure function of (seed, q)."""
    return np.asarray(
        [np.random.SeedSequence([int(seed) & 0xFFFFFFFF, q])
         .generate_state(1, np.uint64)[0] for q in range(rounds)],
        dtype=np.uint64)


def compile_plan(schedule: Schedule, job, *, rounds: Optional[int] = None,
                 n_groups: Optional[int] = None, seed: int = 0,
                 adaptive: bool = False, availability=None, zipf_as=None,
                 grad_density=None, fault_gain=None) -> RunPlan:
    """Lower ``(schedule, job)`` to a :class:`RunPlan`.

    ``job`` is a :class:`repro_torch.api.TrainJob` (anything exposing
    ``make_arch()``, ``global_batch``, ``seq_len``, ``heterogeneity`` and
    ``delay_rounds``).  ``adaptive`` applies the per-round delay-adaptive
    scale from the schedule's delay metadata; the realised buffering depth
    is 1 round whenever ``delay_rounds > 0`` (the trainer's single
    swapped-every-round gbuf)."""
    from ..data import DataConfig, HeterogeneousTokenPipeline

    channels = dict(availability=availability, zipf_as=zipf_as,
                    grad_density=grad_density, fault_gain=fault_gain)
    unported = sorted(k for k, v in channels.items() if v is not None)
    if unported:
        raise NotImplementedError(
            f"plan channels {unported} are not ported yet (scenarios and "
            "faults: ROADMAP.md queue 1)")
    n = n_groups if n_groups is not None else schedule.n_workers
    masks, scales = lower_rounds(
        schedule, rounds,
        delay_rounds=1 if getattr(job, "delay_rounds", 0) > 0 else 0,
        adaptive=adaptive)
    cfg = job.make_arch()
    pipe = HeterogeneousTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=job.seq_len, global_batch=job.global_batch,
        n_groups=n, heterogeneity=job.heterogeneity, seed=seed))
    return RunPlan(
        masks=masks.astype(np.float32),
        delay_scales=scales.astype(np.float32),
        data_keys=round_keys(seed, masks.shape[0]),
        token_cdf=np.cumsum(pipe.pmf).astype(np.float32),
        group_perms=np.stack(pipe.perms).astype(np.int32),
        global_batch=job.global_batch, seq_len=job.seq_len,
        seed=seed, adaptive=adaptive)
