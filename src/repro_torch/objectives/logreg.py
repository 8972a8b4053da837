"""The paper's experimental objective (§5):

    f_i(x) = (1/m) Σ_j log(1 + exp(−b_ij a_ijᵀ x)) + λ Σ_k x_k²/(1 + x_k²)

Counterpart of ``repro/objectives/logreg.py``: the same losses, constants
and plugs, on tensors held on an explicit ``device`` (default CUDA).  The
gradients are closed forms (∂/∂z log(1 + eᶻ) = σ(z), ∂/∂x x²/(1 + x²) =
2x/(1 + x²)²), so no call syncs with the host: ``worker`` may be a 0-d
device int tensor, and a device index never becomes a Python number.

The stochastic oracle takes the mini-batch's row indices ``idx`` (shape
``(bs,)``) in place of the JAX package's PRNG key: threefry cannot be
reproduced by torch generators, so the caller draws the whole ``(T, bs)``
table up front (:meth:`LogRegProblem.batch_table`, the port's own stream)
or injects one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _log1p_exp(z: torch.Tensor) -> torch.Tensor:
    """``logaddexp(0, z)`` (the JAX package's form; not ``softplus``, whose
    linear branch above its threshold rounds differently)."""
    return torch.logaddexp(z, torch.zeros((), dtype=z.dtype, device=z.device))


class LogRegProblem:
    """Distributed logistic regression + nonconvex regulariser.

    features: (n_workers, m, d); labels: (n_workers, m) in {−1, +1}.
    Exposes per-worker full/stochastic gradients and the global loss on
    ``device`` — the plug for :func:`repro_torch.core.simulator.replay`.
    """

    def __init__(self, features, labels, lam: float = 0.1,
                 batch_size: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        A = np.asarray(features, dtype=np.float32)
        b = np.asarray(labels, dtype=np.float32)
        if A.ndim != 3 or b.shape != A.shape[:2]:
            raise ValueError("features (n,m,d) and labels (n,m) expected")
        self.A = torch.from_numpy(A).to(self.device)
        self.b = torch.from_numpy(b).to(self.device)
        self.n, self.m, self.d = A.shape
        self._A2 = self.A.reshape(self.n * self.m, self.d)   # one row per point
        self._b2 = self.b.reshape(self.n * self.m)
        # −b and −b/m per point, so a gradient gathers them instead of
        # recomputing them (fewer launches per replay step)
        self.lam = float(lam)
        self.batch_size = batch_size  # None → full local gradient
        self._negb = -self.b
        self._negb_m = -self.b / self.m
        self._negb_bs = -self._b2 / (batch_size or self.m)
        self._one = torch.ones((), device=self.device)

    # ---- helpers ----------------------------------------------------------------
    def _x(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _row(self, worker) -> torch.Tensor:
        """``worker`` (int or 0-d device tensor) as a 1-element index."""
        if isinstance(worker, torch.Tensor):
            return worker.reshape(1)
        return torch.tensor([int(worker)], device=self.device)

    def _reg(self, x):
        return self.lam * torch.sum(x * x / (1.0 + x * x), dim=-1)

    def _grad(self, a, negb, negb_m, x):
        """∇ of mean_j log(1 + exp(−b_j a_jᵀ x)) over the rows of ``a``
        (``negb`` = −b, ``negb_m`` = −b / rows) plus the regulariser's
        2λx / (1 + x²)², for one point ``x`` (d,)."""
        s = torch.sigmoid(negb * torch.mv(a, x)) * negb_m
        v = torch.addcmul(self._one, x, x)
        return torch.addcdiv(torch.mv(a.T, s), x, v * v, value=2.0 * self.lam)

    # ---- losses -------------------------------------------------------------
    def local_loss(self, x, worker):
        x = self._x(x)
        r = self._row(worker)
        a = self.A.index_select(0, r)[0]
        b = self.b.index_select(0, r)[0]
        return torch.mean(_log1p_exp(-b * (a @ x))) + self._reg(x)

    def loss(self, x):
        """f(x); ``x`` may carry leading batch dims (one loss per row)."""
        x = self._x(x)
        z = -self._b2 * (x @ self._A2.T)
        return torch.mean(_log1p_exp(z), dim=-1) + self._reg(x)

    # ---- gradients ------------------------------------------------------------
    def _local_rows(self, worker):
        """(a, −b, −b/m) of ``worker``'s local data."""
        r = self._row(worker)
        return (self.A.index_select(0, r)[0], self._negb.index_select(0, r)[0],
                self._negb_m.index_select(0, r)[0])

    def _batch_rows(self, worker, idx):
        """(a, −b, −b/bs) of the mini-batch rows ``idx`` of ``worker``."""
        if idx is None:
            raise ValueError("the stochastic oracle needs a mini-batch index "
                             "row (see LogRegProblem.batch_table)")
        w = worker if isinstance(worker, torch.Tensor) else self._row(worker)[0]
        rows = torch.add(idx, w, alpha=self.m)       # flat rows w·m + idx
        return (self._A2.index_select(0, rows),
                self._negb.reshape(-1).index_select(0, rows),
                self._negb_bs.index_select(0, rows))

    def local_grad(self, x, worker):
        """Full local gradient ∇f_i(x)."""
        return self._grad(*self._local_rows(worker), self._x(x))

    def stochastic_grad(self, x, worker, idx):
        """Mini-batch gradient over the worker's rows ``idx`` (Assumption 2);
        ``idx`` is one row of :meth:`batch_table`."""
        return self._grad(*self._batch_rows(worker, idx), self._x(x))

    def full_grad(self, x):
        """∇f(x) at one point ``x`` (d,)."""
        negb = self._negb.reshape(-1)
        return self._grad(self._A2, negb, negb / (self.n * self.m), self._x(x))

    def batch_table(self, T: int, generator: torch.Generator) -> torch.Tensor:
        """(T, bs) int64 mini-batch rows on the CPU: row t holds ``bs``
        distinct indices in [0, m), drawn without replacement from
        ``generator`` (the port's own stream, not the JAX package's)."""
        bs = self.batch_size or self.m
        keys = torch.rand((T, self.m), generator=generator)
        return keys.argsort(dim=1, stable=True)[:, :bs].contiguous()

    # ---- plugs for the simulator ----------------------------------------------
    def grad_fn(self, stochastic: bool = False):
        """``g(x, worker, idx)``.  Within a replay step every γ of a grid
        asks for the same ``worker`` and ``idx`` tensors, so ``g`` gathers
        their rows once and reuses them while the next call passes the
        same two objects (compared by identity: a caller that rewrites a
        worker tensor in place must pass a new one)."""
        gather = ((lambda w, idx: self._batch_rows(w, idx)) if stochastic
                  else (lambda w, idx: self._local_rows(w)))
        last = []                                   # [worker, idx, rows]

        def g(x, w, idx):
            if not last or last[0] is not w or last[1] is not idx:
                last[:] = [w, idx, gather(w, idx)]
            return self._grad(*last[2], x)
        return g

    def per_worker_grad_fn(self):
        return lambda x, w: self.local_grad(x, w)

    # ---- problem constants for theory.py ---------------------------------------
    def smoothness_bound(self) -> float:
        """L ≤ max_i ||A_i||²_op/(4m) + 2λ (logistic) — cheap upper bound."""
        A = self.A.cpu().numpy()
        ops = [np.linalg.norm(A[i], ord=2) ** 2 / (4.0 * self.m) for i in range(self.n)]
        return float(max(ops) + 2.0 * self.lam)

    def zeta(self, x) -> float:
        gs = np.stack([self.local_grad(x, i).cpu().numpy() for i in range(self.n)])
        gbar = gs.mean(0)
        return float(np.max(np.linalg.norm(gs - gbar, axis=-1)))

    # ---- single-node view (each data point = one client, §3.2) -----------------
    def as_single_node(self) -> "LogRegProblem":
        A = self.A.cpu().numpy().reshape(self.n * self.m, 1, self.d)
        b = self.b.cpu().numpy().reshape(self.n * self.m, 1)
        return LogRegProblem(A, b, lam=self.lam, device=self.device)
