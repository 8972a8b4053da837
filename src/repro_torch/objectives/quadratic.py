"""Analytic quadratic objective — exact closed forms for unit tests.

f_i(x) = ½ (x − c_i)ᵀ H_i (x − c_i);  ∇f_i(x) = H_i (x − c_i).

Counterpart of ``repro/objectives/quadratic.py`` on tensors held on an
explicit ``device`` (default CUDA); ``worker`` may be a 0-d device int
tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


class QuadraticProblem:
    def __init__(self, centers, hessians=None, device="cuda"):
        self.device = resolve_device(device)
        c = np.asarray(centers, dtype=np.float32)               # (n, d)
        self.n, self.d = c.shape
        if hessians is None:
            hessians = np.stack([np.eye(self.d)] * self.n)
        H = np.asarray(hessians, dtype=np.float32)              # (n, d, d)
        self.c = torch.from_numpy(c).to(self.device)
        self.H = torch.from_numpy(H).to(self.device)

    def _x(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _local_grad(self, x, worker):
        r = (worker.reshape(1) if isinstance(worker, torch.Tensor)
             else torch.tensor([int(worker)], device=self.device))
        H = self.H.index_select(0, r)[0]
        c = self.c.index_select(0, r)[0]
        return H @ (x - c)

    def local_grad(self, x, worker):
        return self._local_grad(self._x(x), worker)

    def full_grad(self, x):
        """∇f(x); ``x`` may carry leading batch dims (as may ``loss``'s)."""
        r = self._x(x).unsqueeze(-2) - self.c                   # (..., n, d)
        return torch.einsum("nde,...ne->...nd", self.H, r).mean(dim=-2)

    def loss(self, x):
        r = self._x(x).unsqueeze(-2) - self.c
        return 0.5 * torch.einsum("...nd,ndk,...nk->...n", r, self.H, r).mean(dim=-1)

    def grad_fn(self, stochastic: bool = False):
        return lambda x, w, idx: self._local_grad(x, w)

    def per_worker_grad_fn(self):
        return lambda x, w: self.local_grad(x, w)

    def minimizer(self):
        H = self.H.cpu().numpy()
        c = self.c.cpu().numpy()
        Hbar = np.mean(H, axis=0)
        rhs = np.mean(np.einsum("ndk,nk->nd", H, c), axis=0)
        return np.linalg.solve(Hbar, rhs)
