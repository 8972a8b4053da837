"""Synthetic dataset generation — Appendix A.2, followed step by step.

Syn(α, β): larger α, β ⇒ more heterogeneous local datasets.
Also provides w7a/phishing stand-ins with matched (n, m, d, sparsity):
LibSVM is not reachable offline, so we generate data with the same shape
statistics and run the identical protocol (noted in DESIGN.md §8).
"""
from __future__ import annotations

import numpy as np


def make_synthetic(alpha: float, beta: float, n: int = 10, m: int = 200,
                   d: int = 300, seed: int = 0):
    """Appendix A.2 generator, verbatim:

    1. B_i ~ N(0, β);  2. v_i ∈ R^d, [v_i]_j ~ N(B_i, 1);
    3. a_ij ~ N(v_i, Σ), Σ_kk = k^{−1.2};
    4. u_i ~ N(0, α), c_i ~ N(u_i, 1);  5. [w_i]_j ~ N(u_i, 1);
    6. p_ij = σ(w_iᵀ a_ij + c_i);  7. b_ij = −1 w.p. p_ij else +1.
    """
    rng = np.random.default_rng(seed)
    B = rng.normal(0.0, np.sqrt(beta), size=n)
    v = rng.normal(B[:, None], 1.0, size=(n, d))
    Sigma = np.diag((np.arange(1, d + 1) ** -1.2))
    a = np.einsum("nmd,dk->nmk", rng.normal(0.0, 1.0, size=(n, m, d)), np.sqrt(Sigma))
    a = a + v[:, None, :]
    u = rng.normal(0.0, np.sqrt(alpha), size=n)
    c = rng.normal(u, 1.0)
    w = rng.normal(u[:, None], 1.0, size=(n, d))
    logits = np.einsum("nd,nmd->nm", w, a) + c[:, None]
    p = np.where(logits >= 0, 1.0 / (1.0 + np.exp(-np.abs(logits))),
                 np.exp(-np.abs(logits)) / (1.0 + np.exp(-np.abs(logits))))
    b = np.where(rng.uniform(size=(n, m)) < p, -1.0, 1.0)
    return a.astype(np.float32), b.astype(np.float32)


def make_libsvm_like(name: str, n: int = 10, seed: int = 0):
    """Stand-ins for the LibSVM datasets used in §5 (offline container):

    * w7a:      n=10 workers, m=2505, d=300, sparse binary-ish features
    * phishing: n=10 workers, m=1105, d=68, dense features in [0, 1]
    """
    import zlib
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2 ** 16)
    if name == "w7a":
        m, d, density = 2505, 300, 0.04
        feats = (rng.uniform(size=(n, m, d)) < density).astype(np.float32)
        wstar = rng.normal(size=d) * (rng.uniform(size=d) < 0.3)
        shift = rng.normal(0.0, 0.5, size=(n, 1))        # worker covariate shift
        logits = feats @ wstar + shift
        labels = np.where(logits + rng.logistic(size=(n, m)) > 0, 1.0, -1.0)
        # w7a is heavily imbalanced (~3% positives); skew it
        labels = np.where(rng.uniform(size=(n, m)) < 0.9, -1.0, labels)
    elif name == "phishing":
        m, d = 1105, 68
        feats = rng.uniform(size=(n, m, d)).astype(np.float32)
        wstar = rng.normal(size=d)
        shift = rng.normal(0.0, 0.5, size=(n, 1))
        logits = feats @ wstar - np.median(feats @ wstar) + shift
        labels = np.where(logits + rng.logistic(size=(n, m)) > 0, 1.0, -1.0)
    else:
        raise ValueError(f"unknown dataset {name!r}")
    return feats.astype(np.float32), labels.astype(np.float32)
