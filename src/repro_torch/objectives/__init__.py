"""The theory tier's objectives.

Counterpart of ``repro/objectives``: ``synthetic`` is a verbatim numpy copy
(the same arrays bit for bit); the problems hold their tensors on an
explicit ``device`` (default CUDA).
"""
from .logreg import LogRegProblem
from .synthetic import make_synthetic, make_libsvm_like
from .quadratic import QuadraticProblem

__all__ = ["LogRegProblem", "make_synthetic", "make_libsvm_like", "QuadraticProblem"]
