"""Synthetic heterogeneous token pipeline.

Each AsGrad worker group g ∈ [n] owns its own token distribution (a Zipf
law over a group-specific vocabulary permutation — cheap, deterministic,
and *measurably* heterogeneous: per-group gradients differ, which is the ζ²
regime the paper studies).  The pipeline is host-side numpy; batches are
laid out so group g owns the contiguous example slice [g·B/n, (g+1)·B/n),
matching ``AsyncTrainer._example_weights``.

Also provides epoch shuffling (random-reshuffling / shuffle-once) over a
finite synthetic corpus for the single-node special cases.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def zipf_pmf(vocab: int, a: float) -> np.ndarray:
    """Normalised Zipf pmf over ranks 1..vocab with exponent ``a``.

    The single source of the token marginal law: the host pipeline, the
    compiled plan's static inverse-CDF table, AND the scenario layer's
    drifting-exponent CDF bank all build from this, so a drifting world
    whose trajectory passes through ``a`` samples the exact distribution
    the stationary world at ``a`` uses."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    pmf = ranks ** (-float(a))
    return pmf / pmf.sum()


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_groups: int = 1
    heterogeneity: float = 1.0    # 0 = iid groups, larger = more skew
    zipf_a: float = 1.2
    seed: int = 0


class HeterogeneousTokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_groups:
            raise ValueError("global_batch must divide n_groups")
        rng = np.random.default_rng(cfg.seed)
        base = np.arange(cfg.vocab)
        self.perms = []
        for g in range(cfg.n_groups):
            p = base.copy()
            swap = int(cfg.heterogeneity * cfg.vocab)
            if swap > 1:
                idx = rng.choice(cfg.vocab, size=min(swap, cfg.vocab), replace=False)
                p[idx] = rng.permutation(p[idx])
            self.perms.append(p)
        self.pmf = zipf_pmf(cfg.vocab, cfg.zipf_a)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 7919 * step + 1)
        per = cfg.global_batch // cfg.n_groups
        out = np.empty((cfg.global_batch, cfg.seq_len), np.int32)
        for g in range(cfg.n_groups):
            draws = rng.choice(cfg.vocab, size=(per, cfg.seq_len), p=self.pmf)
            out[g * per:(g + 1) * per] = self.perms[g][draws]
        return {"tokens": out}


class EpochShuffler:
    """RR / shuffle-once index streams over a corpus of N examples."""

    def __init__(self, n_examples: int, seed: int = 0, reshuffle: bool = True):
        self.n = n_examples
        self.reshuffle = reshuffle
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(self.n)
        self._i = 0

    def next_indices(self, k: int) -> np.ndarray:
        out = []
        while len(out) < k:
            take = min(k - len(out), self.n - self._i)
            out.extend(self._perm[self._i:self._i + take])
            self._i += take
            if self._i == self.n:
                self._i = 0
                if self.reshuffle:
                    self._perm = self._rng.permutation(self.n)
        return np.asarray(out)
