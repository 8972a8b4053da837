"""Table 1 convergence-rate calculator + tuned-stepsize rules.

Every row of Table 1 (the paper's headline result) is a function of the
problem constants (L, F₀, σ², ζ², G) and the schedule constants (τ_C, τ_max,
T, b, n).  These are *upper bounds on E‖∇f(x̂)‖²*; benchmarks/table1_rates.py
compares their shape against measured convergence.

Stepsize rules implement the Propositions' tuning (C.1–C.3, D.1–D.5).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ProblemConstants:
    L: float          # smoothness (Assumption 1)
    F0: float         # initial suboptimality f(x0) − f*
    sigma2: float     # stochastic-gradient variance (Assumption 2)
    zeta2: float      # heterogeneity (Assumption 3)
    G: float = 0.0    # gradient bound (Assumption 4), 0 = unavailable


def _chk(c: ProblemConstants, bounded_grad: bool):
    if bounded_grad and c.G <= 0:
        raise ValueError("this rate requires Assumption 4 (G > 0)")


# ----------------------------------------------------------------------------
# Table 1 rows (our rates).
# ----------------------------------------------------------------------------

def pure_async(c: ProblemConstants, T: int, tau_c: int, tau_max: int,
               bounded_grad: bool = False) -> float:
    """Alg 2.  No-BG: L F₀ √(τ_max τ_C)/T + √(L F₀ σ²/T) + ζ².
    BG:  L F₀ τ_C/T + √(L F₀ σ²/T) + (L F₀ G τ_C/T)^{2/3} + ζ²."""
    if not bounded_grad:
        return (c.L * c.F0 * math.sqrt(tau_max * tau_c) / T
                + math.sqrt(c.L * c.F0 * c.sigma2 / T) + c.zeta2)
    _chk(c, True)
    return (c.L * c.F0 * tau_c / T
            + math.sqrt(c.L * c.F0 * c.sigma2 / T)
            + (c.L * c.F0 * c.G * tau_c / T) ** (2.0 / 3.0) + c.zeta2)


def pure_async_waiting(c: ProblemConstants, T: int, tau_c: int, tau_max: int,
                       b: int, bounded_grad: bool = False) -> float:
    """Alg 3."""
    if not bounded_grad:
        return (c.L * c.F0 * math.sqrt(tau_max * tau_c) / (T * math.sqrt(b))
                + math.sqrt(c.L * c.F0 * c.sigma2 / (T * b)) + c.zeta2)
    _chk(c, True)
    return (c.L * c.F0 * tau_c / (T * b)
            + math.sqrt(c.L * c.F0 * c.sigma2 / (T * b))
            + (c.L * c.F0 * c.G * tau_c / (T * b)) ** (2.0 / 3.0) + c.zeta2)


def random_async(c: ProblemConstants, T: int, tau_c: int) -> float:
    """Alg 4 (ours, BG): L F₁ τ_C/T + √(LF₁σ²/T) + √(LF₁ζ²/T) + (LF₁τ_C G/T)^{2/3}."""
    _chk(c, True)
    return (c.L * c.F0 * tau_c / T
            + math.sqrt(c.L * c.F0 * c.sigma2 / T)
            + math.sqrt(c.L * c.F0 * c.zeta2 / T)
            + (c.L * c.F0 * tau_c * c.G / T) ** (2.0 / 3.0))


def fedbuff(c: ProblemConstants, T: int, tau_c: int, b: int) -> float:
    """Alg 5 (random async with waiting), ours."""
    _chk(c, True)
    return (c.L * c.F0 * tau_c / T
            + math.sqrt(c.L * c.F0 * c.zeta2 / (T * b))
            + math.sqrt(c.L * c.F0 * c.sigma2 / (T * b))
            + (c.L * c.F0 * tau_c * c.G / (T * b)) ** (2.0 / 3.0))


def shuffled_async(c: ProblemConstants, T: int, n: int) -> float:
    """Alg 6 [NEW]: LnF₁/T + √(LF₁σ²/T) + (LF₁√n ζ/T)^{2/3} + (LF₁Gn/T)^{2/3}."""
    _chk(c, True)
    z = math.sqrt(c.zeta2)
    return (c.L * n * c.F0 / T
            + math.sqrt(c.L * c.F0 * c.sigma2 / T)
            + (c.L * c.F0 * math.sqrt(n) * z / T) ** (2.0 / 3.0)
            + (c.L * c.F0 * c.G * n / T) ** (2.0 / 3.0))


def minibatch_sgd(c: ProblemConstants, T: int, b: int) -> float:
    """Prop. C.2: LF₀/T + √(LF₀ζ²/(Tb)) (single-node view, ζ² = variance)."""
    return c.L * c.F0 / T + math.sqrt(c.L * c.F0 * c.zeta2 / (T * b))


def sgd_rr(c: ProblemConstants, T: int, n: int) -> float:
    """Prop. C.4: LF₀n/T + (LF₀√n ζ/T)^{2/3}."""
    z = math.sqrt(c.zeta2)
    return (c.L * c.F0 * n / T
            + (c.L * c.F0 * math.sqrt(n) * z / T) ** (2.0 / 3.0))


# ----------------------------------------------------------------------------
# Crossover analysis (Remark 1 / §D.3.3): shuffled beats random iff ζ ≥ √n·√ε.
# ----------------------------------------------------------------------------

def shuffled_beats_random(zeta: float, n: int, eps: float) -> bool:
    return zeta >= math.sqrt(n) * math.sqrt(eps)


# ----------------------------------------------------------------------------
# Tuned stepsizes from the Propositions (constants dropped, as in the paper).
# ----------------------------------------------------------------------------

def stepsize_pure_async(c: ProblemConstants, T: int, tau_c: int, tau_max: int) -> float:
    return min(1.0 / (c.L * math.sqrt(max(tau_max * tau_c, 1))),
               math.sqrt(c.F0 / (c.L * max(c.sigma2, 1e-12) * T)))


def stepsize_random_async(c: ProblemConstants, T: int, tau_c: int) -> float:
    cands = [1.0 / (c.L * max(tau_c, 1))]
    if c.sigma2 > 0:
        cands.append(math.sqrt(c.F0 / (c.L * c.sigma2 * T)))
    if c.zeta2 > 0:
        cands.append(math.sqrt(c.F0 / (c.L * c.zeta2 * T)))
    if c.G > 0:
        cands.append((c.F0 / (c.L ** 2 * tau_c ** 2 * c.G ** 2 * T)) ** (1.0 / 3.0))
    return min(cands)


def stepsize_shuffled_async(c: ProblemConstants, T: int, n: int) -> float:
    cands = [1.0 / (30.0 * c.L * n)]
    if c.zeta2 > 0:
        cands.append((c.F0 / (c.L ** 2 * n * c.zeta2 * T)) ** (1.0 / 3.0))
    if c.G > 0:
        cands.append((c.F0 / (c.L ** 2 * n ** 2 * c.G ** 2 * T)) ** (1.0 / 3.0))
    return min(cands)


RATES = {
    "pure": pure_async,
    "pure_waiting": pure_async_waiting,
    "random": random_async,
    "fedbuff": fedbuff,
    "shuffled": shuffled_async,
    "minibatch": minibatch_sgd,
    "rr": sgd_rr,
}
