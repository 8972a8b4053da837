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

The scenario channels lower as in the JAX package, by the same numpy code
(array-equal to its plan, error messages included): ``availability`` is
multiplied into the masks, a ``zipf_as`` trajectory quantises into
``cdf_bank`` / ``cdf_index``, and ``grad_density`` / ``fault_gain`` ride
as per-round arrays.  ``compile_plan(..., grid_gammas=...)`` adds the
γ-axis, ``grid_scales``, that the executor's grid lane steps every grid
point over (:meth:`repro_torch.runtime.PlanExecutor.run_grid`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

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

    ``grid_scales`` is the optional γ-axis: ``(n_grid, rounds)`` f32
    per-round stepsize scales, one row per grid point (``γ_g/γ_base ×
    delay_scales``).  The ordering, masks and data keys do not depend on
    γ, so one plan serves the whole grid.

    Scenario channels (``repro_torch.scenarios`` worlds; all optional, all
    ``None`` for a stationary plan):

    * elastic membership has no channel of its own — the availability
      table is folded into ``masks`` at compile time (a down worker's mask
      entry is zeroed, hard-dropping its residual in-flight receipts),
    * ``cdf_bank``/``cdf_index`` — drifting data law: ``(n_phases,
      vocab)`` f32 cumulative Zipf pmfs and the ``(rounds,)`` int32 row
      index per round; round q samples tokens from
      ``cdf_bank[cdf_index[q]]``,
    * ``grad_density`` — ``(rounds,)`` f32 keep-densities in (0, 1]:
      per-leaf magnitude top-k gradient sparsification inside the train
      step (1.0 ⇒ exact no-op),
    * ``fault_gain`` — ``(rounds, n_groups)`` f32 per-worker loss-weight
      gains (``repro_torch.faults``): 1.0 neutral, huge-but-finite =
      corrupted receipt, NaN = poisoned receipt.  Only participating
      workers' gains matter (the mask zeroes the rest).
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
    grid_scales: Optional[np.ndarray] = None
    cdf_bank: Optional[np.ndarray] = None
    cdf_index: Optional[np.ndarray] = None
    grad_density: Optional[np.ndarray] = None
    fault_gain: Optional[np.ndarray] = None

    @property
    def rounds(self) -> int:
        return int(self.masks.shape[0])

    @property
    def n_groups(self) -> int:
        return int(self.masks.shape[1])

    @property
    def vocab(self) -> int:
        return int(self.token_cdf.shape[0])

    @property
    def n_grid(self) -> int:
        """Grid points on the γ-axis (0 when the plan has none)."""
        return 0 if self.grid_scales is None \
            else int(self.grid_scales.shape[0])

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
        if self.grid_scales is not None and (
                self.grid_scales.ndim != 2
                or self.grid_scales.shape[1] != self.masks.shape[0]
                or not self.grid_scales.shape[0]):
            raise ValueError(
                f"grid_scales must be (n_grid >= 1, rounds="
                f"{self.masks.shape[0]}); got "
                f"{self.grid_scales.shape}")
        if (self.cdf_bank is None) != (self.cdf_index is None):
            raise ValueError("cdf_bank and cdf_index must be set together")
        if self.cdf_bank is not None:
            if self.cdf_bank.ndim != 2 or \
                    self.cdf_bank.shape[1] != self.vocab:
                raise ValueError(
                    f"cdf_bank must be (n_phases, vocab={self.vocab}); got "
                    f"{self.cdf_bank.shape}")
            if self.cdf_index.shape != (self.rounds,):
                raise ValueError(
                    f"cdf_index must be (rounds={self.rounds},); got "
                    f"{self.cdf_index.shape}")
            if self.cdf_index.min(initial=0) < 0 or \
                    self.cdf_index.max(initial=0) >= self.cdf_bank.shape[0]:
                raise ValueError("cdf_index out of cdf_bank range")
        if self.grad_density is not None:
            if self.grad_density.shape != (self.rounds,):
                raise ValueError(
                    f"grad_density must be (rounds={self.rounds},); got "
                    f"{self.grad_density.shape}")
            if np.any(self.grad_density <= 0) or \
                    np.any(self.grad_density > 1):
                raise ValueError("grad_density values must be in (0, 1]")
        if self.fault_gain is not None:
            if self.fault_gain.shape != (self.rounds, self.n_groups):
                raise ValueError(
                    f"fault_gain must be (rounds={self.rounds}, "
                    f"n_groups={self.n_groups}); got {self.fault_gain.shape}")
            # NaN compares False everywhere, so this only rejects real zeros
            if np.any(self.fault_gain == 0):
                raise ValueError(
                    "fault_gain must not contain zeros — drop workers via "
                    "the availability channel, not a zero gain")

    def grid_slice(self, lo: int = 0, hi: Optional[int] = None):
        """``(n_grid, hi-lo)`` per-γ scale columns for one chunk (host
        numpy; the executor moves them to the device)."""
        if self.grid_scales is None:
            raise ValueError("plan has no γ-axis (grid_scales is None)")
        hi = self.rounds if hi is None else hi
        return self.grid_scales[:, lo:hi]

    def summary(self) -> dict:
        """The JAX plan's summary keys."""
        return {"rounds": self.rounds, "n_groups": self.n_groups,
                "vocab": self.vocab, "global_batch": self.global_batch,
                "seq_len": self.seq_len, "seed": self.seed,
                "adaptive": self.adaptive, "n_grid": self.n_grid,
                "n_cdf_phases": (0 if self.cdf_bank is None
                                 else int(self.cdf_bank.shape[0])),
                "sparsified": self.grad_density is not None,
                "faulted": self.fault_gain is not None}


def round_keys(seed: int, rounds: int) -> np.ndarray:
    """``(rounds,)`` uint64: round q's generator seed, drawn from
    ``SeedSequence([seed, q])`` — a pure function of (seed, q)."""
    return np.asarray(
        [np.random.SeedSequence([int(seed) & 0xFFFFFFFF, q])
         .generate_state(1, np.uint64)[0] for q in range(rounds)],
        dtype=np.uint64)


def quantize_zipf_trajectory(zipf_as: np.ndarray, vocab: int,
                             n_phases: int = 8):
    """Quantise a per-round Zipf-exponent trajectory into a CDF bank.

    Returns ``(cdf_bank (n_phases', vocab) f32, cdf_index (rounds,)
    int32)`` with ``n_phases' <= n_phases`` distinct levels (nearest-level
    rounding on a linear grid between the trajectory's extremes; a
    constant trajectory collapses to one phase).  Each bank row is the
    cumulative :func:`repro_torch.data.zipf_pmf` at that exponent — the
    same inverse-CDF table a stationary plan at that exponent would carry.
    """
    from ..data import zipf_pmf

    z = np.asarray(zipf_as, dtype=np.float64)
    if z.ndim != 1 or not z.size:
        raise ValueError("zipf_as must be a non-empty 1-D trajectory")
    if np.any(z <= 0):
        raise ValueError("zipf exponents must be positive")
    lo, hi = float(z.min()), float(z.max())
    if hi - lo < 1e-12:
        levels = np.asarray([lo])
    else:
        levels = np.linspace(lo, hi, max(int(n_phases), 2))
    idx = np.argmin(np.abs(z[:, None] - levels[None, :]), axis=1)
    used = np.unique(idx)
    remap = np.zeros(len(levels), dtype=np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    bank = np.stack([np.cumsum(zipf_pmf(vocab, levels[u])) for u in used])
    return bank.astype(np.float32), remap[idx].astype(np.int32)


def _pad_rows(x: np.ndarray, R: int, fill) -> np.ndarray:
    """``x[:R]``, padded to R rows with ``fill`` (the channel's neutral
    value) when shorter."""
    if x.shape[0] < R:
        pad = np.full((R - x.shape[0],) + x.shape[1:], fill, x.dtype)
        x = np.concatenate([x, pad])
    return x[:R]


def compile_plan(schedule: Schedule, job, *, rounds: Optional[int] = None,
                 n_groups: Optional[int] = None, seed: int = 0,
                 adaptive: bool = False,
                 grid_gammas: Optional[Sequence[float]] = None,
                 base_gamma: Optional[float] = None,
                 availability: Optional[np.ndarray] = None,
                 zipf_as: Optional[np.ndarray] = None,
                 grad_density: Optional[np.ndarray] = None,
                 fault_gain: Optional[np.ndarray] = None,
                 n_cdf_phases: int = 8) -> RunPlan:
    """Lower ``(schedule, job)`` to a :class:`RunPlan`.

    ``job`` is a :class:`repro_torch.api.TrainJob` (anything exposing
    ``make_arch()``, ``global_batch``, ``seq_len``, ``heterogeneity`` and
    ``delay_rounds``).  ``adaptive`` applies the per-round delay-adaptive
    scale from the schedule's delay metadata; the realised buffering depth
    is 1 round whenever ``delay_rounds > 0`` (the trainer's single
    swapped-every-round gbuf).

    ``grid_gammas`` adds the γ-axis: one ``grid_scales`` row per grid
    point, ``γ_g / base_gamma`` (default ``base_gamma = grid_gammas[0]``,
    the lr the executing trainer was built with) times the per-round
    scales; the optimizer applies ``lr · scale`` everywhere, so scaling
    the scale is running at γ_g.  Every row folds the whole stepsize
    policy in, so the grid lane always calls the explicit-scale step.

    Scenario channels (typically from a realised
    :class:`repro_torch.scenarios.ScenarioWorld`):

    * ``availability`` — ``(rounds', n)`` 0/1 membership, multiplied into
      the participation masks (elastic hard-drop),
    * ``zipf_as`` — ``(rounds',)`` Zipf-exponent trajectory, quantised via
      :func:`quantize_zipf_trajectory` into ``cdf_bank``/``cdf_index``,
    * ``grad_density`` — ``(rounds',)`` keep-densities in (0, 1],
    * ``fault_gain`` — ``(rounds', n)`` per-worker loss-weight gains
      (``repro_torch.faults``; NaN = poisoned receipt).

    Shorter channels than the plan's rounds are padded with their neutral
    value (all-up / last exponent / density 1 / gain 1)."""
    from ..data import DataConfig, HeterogeneousTokenPipeline

    n = n_groups if n_groups is not None else schedule.n_workers
    masks, scales = lower_rounds(
        schedule, rounds,
        delay_rounds=1 if getattr(job, "delay_rounds", 0) > 0 else 0,
        adaptive=adaptive)
    R = masks.shape[0]
    if availability is not None:
        avail = np.asarray(availability, dtype=np.float32)
        if avail.ndim != 2 or avail.shape[1] != masks.shape[1]:
            raise ValueError(
                f"availability must be (rounds, n_workers="
                f"{masks.shape[1]}); got {avail.shape}")
        masks = masks * _pad_rows(avail, R, 1.0)
    cfg = job.make_arch()
    cdf_bank = cdf_index = None
    if zipf_as is not None:
        z = np.asarray(zipf_as, dtype=np.float64)
        z = _pad_rows(z, R, z[-1])
        cdf_bank, cdf_index = quantize_zipf_trajectory(z, cfg.vocab,
                                                       n_cdf_phases)
    density = None
    if grad_density is not None:
        density = _pad_rows(np.asarray(grad_density, dtype=np.float32), R,
                            1.0)
    gain = None
    if fault_gain is not None:
        gain = np.asarray(fault_gain, dtype=np.float32)
        if gain.ndim != 2 or gain.shape[1] != masks.shape[1]:
            raise ValueError(
                f"fault_gain must be (rounds, n_workers="
                f"{masks.shape[1]}); got {gain.shape}")
        gain = _pad_rows(gain, R, 1.0)
    grid_scales = None
    if grid_gammas is not None:
        g = np.asarray([float(x) for x in grid_gammas], np.float32)
        if g.ndim != 1 or not g.size:
            raise ValueError("grid_gammas must be a non-empty 1-D sequence")
        base = np.float32(base_gamma if base_gamma is not None else g[0])
        grid_scales = ((g / base)[:, None]
                       * scales[None, :]).astype(np.float32)
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
        seed=seed, adaptive=adaptive, grid_scales=grid_scales,
        cdf_bank=cdf_bank,
        cdf_index=cdf_index, grad_density=density, fault_gain=gain)
