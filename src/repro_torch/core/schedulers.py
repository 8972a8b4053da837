"""Job-assignment policies — the lever the AsGrad server controls (§3.1).

A :class:`Scheduler` answers two questions:

* which workers get the very first jobs (``initial_workers`` → A_1), and
* after each server model update, which workers get new jobs
  (``next_workers``).

``wait_b`` encodes the "waiting" variants (Alg 3/5): the server performs one
model update per ``b`` received gradients, all new jobs are assigned at the
round boundary α = ⌊t/b⌋·b, and the effective per-gradient stepsize is γ/b
(Prop. C.2 shows the sequential view is exactly equivalent).

Schedulers are host-side, cheap, and deterministic given their seed.  The
same objects drive both the exact discrete-event engine and the distributed
trainer's round masks, so theory-tier and production-tier orderings are
identical by construction.
"""
from __future__ import annotations

import numpy as np


class Scheduler:
    """Base class.  Subclasses override assignment behaviour."""

    #: server updates the model once per ``wait_b`` received gradients
    wait_b: int = 1
    name: str = "base"

    def __init__(self, n_workers: int, seed: int = 0):
        self.n = int(n_workers)
        self.seed = seed
        self.reset()

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def initial_workers(self):
        """Workers receiving jobs at x_0 (the set A_1).  Default: all."""
        return list(range(self.n))

    def next_workers(self, finished):
        """New assignments after a server update.

        ``finished``: the workers whose gradients formed the update (length
        ``wait_b``).  Returns the list of workers to assign new jobs to.
        """
        raise NotImplementedError

    # -- concurrency bound used by theory ------------------------------------
    def concurrency(self) -> int:
        """τ_C implied by this policy when all workers start busy."""
        return self.n


class PureAsync(Scheduler):
    """Alg 2: k_{t+1} = i_t — a finishing worker is immediately re-assigned
    at the freshly updated model (α_{t+1} = t+1)."""

    name = "pure"

    def next_workers(self, finished):
        return list(finished)


class PureAsyncWaiting(PureAsync):
    """Alg 3: wait for the first b workers, update once with their average,
    re-assign the same b workers at the round boundary."""

    name = "pure_waiting"

    def __init__(self, n_workers: int, b: int, seed: int = 0):
        if not 1 <= b <= n_workers:
            raise ValueError("need 1 <= b <= n_workers")
        self.wait_b = int(b)
        super().__init__(n_workers, seed)


class RandomAsync(Scheduler):
    """Alg 4 [Koloskova et al. 2022]: a fresh worker k ~ Uni[n] gets the new
    job regardless of whether it is busy (jobs queue per worker)."""

    name = "random"

    def next_workers(self, finished):
        return [int(self._rng.integers(self.n))]


class RandomAsyncWaiting(Scheduler):
    """Alg 5 (FedBuff with Q=1): wait for b, then assign to b workers sampled
    uniformly without replacement at the round boundary."""

    name = "fedbuff"

    def __init__(self, n_workers: int, b: int, seed: int = 0):
        if not 1 <= b <= n_workers:
            raise ValueError("need 1 <= b <= n_workers")
        self.wait_b = int(b)
        super().__init__(n_workers, seed)

    def next_workers(self, finished):
        return [int(w) for w in self._rng.choice(self.n, self.wait_b, replace=False)]


class ShuffledAsync(Scheduler):
    """Alg 6 [NEW in this paper]: jobs are assigned following a random
    permutation χ of workers, cycling; χ is re-sampled each cycle
    (``reshuffle=True``) or sampled once (shuffle-once)."""

    name = "shuffled"

    def __init__(self, n_workers: int, seed: int = 0, reshuffle: bool = True):
        self.reshuffle = reshuffle
        super().__init__(n_workers, seed)

    def reset(self) -> None:
        super().reset()
        self._perm = self._rng.permutation(self.n)
        self._r = 0

    def _advance(self) -> int:
        w = int(self._perm[self._r])
        self._r += 1
        if self._r == self.n:
            self._r = 0
            if self.reshuffle:
                self._perm = self._rng.permutation(self.n)
        return w

    def next_workers(self, finished):
        return [self._advance()]


class MiniBatch(Scheduler):
    """§3.2: mini-batch SGD as AsGrad — treat each data point as a client;
    the server assigns b uniform-without-replacement jobs at the same point
    and waits for all of them (τ_max = τ_C = b − 1)."""

    name = "minibatch"

    def __init__(self, n_workers: int, b: int, seed: int = 0):
        if not 1 <= b <= n_workers:
            raise ValueError("need 1 <= b <= n_workers")
        self.wait_b = int(b)
        super().__init__(n_workers, seed)

    def initial_workers(self):
        return [int(w) for w in self._rng.choice(self.n, self.wait_b, replace=False)]

    def next_workers(self, finished):
        return [int(w) for w in self._rng.choice(self.n, self.wait_b, replace=False)]

    def concurrency(self) -> int:
        return self.wait_b


class RandomReshuffling(Scheduler):
    """§3.2: single-node SGD-RR / shuffle-once.  Concurrency 1, zero delays:
    each gradient is computed at the latest model, in permutation order."""

    name = "rr"

    def __init__(self, n_workers: int, seed: int = 0, reshuffle: bool = True):
        self.reshuffle = reshuffle
        super().__init__(n_workers, seed)

    def reset(self) -> None:
        super().reset()
        self._perm = self._rng.permutation(self.n)
        self._r = 0

    def initial_workers(self):
        w = int(self._perm[self._r])
        self._r += 1
        return [w]

    def next_workers(self, finished):
        if self._r == self.n:
            self._r = 0
            if self.reshuffle:
                self._perm = self._rng.permutation(self.n)
        w = int(self._perm[self._r])
        self._r += 1
        return [w]

    def concurrency(self) -> int:
        return 1


REGISTRY = {
    cls.name: cls
    for cls in (
        PureAsync,
        PureAsyncWaiting,
        RandomAsync,
        RandomAsyncWaiting,
        ShuffledAsync,
        MiniBatch,
        RandomReshuffling,
    )
}


def make_scheduler(name: str, n_workers: int, b: int = 1, seed: int = 0, **kw):
    """Factory used by configs / CLIs."""
    cls = REGISTRY[name]
    if cls in (PureAsyncWaiting, RandomAsyncWaiting, MiniBatch):
        return cls(n_workers, b=b, seed=seed, **kw)
    return cls(n_workers, seed=seed, **kw)
