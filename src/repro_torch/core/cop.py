"""Cost of Privacy (Theorem 2): bounds, constant fitting, collaboration value
(an own numpy copy of repro/core/cop.py).

Eq. (11), large-T form:
    E{f(theta_L,T)} - f(theta*) <= (c1/n) sqrt(S) + (c2/n^2) S,
    S := sum_i 1/eps_i^2.

These forecasts are first-class: they let data owners predict private-model
quality during budget negotiation *without* revealing data (Section 6).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def budget_sum(epsilons: Sequence[float]) -> float:
    return float(sum(1.0 / e ** 2 for e in epsilons))


def bound_theorem2(T: int, N: int, n: int, epsilons: Sequence[float],
                   c1: float, c2: float) -> float:
    """Finite-T bound, eq. (8)/(9) inner term."""
    s = sum((1.0 / T + 2.0 * np.sqrt(2.0) / (n * e)) ** 2 for e in epsilons)
    inner = 1.0 / T ** 2 + N * s
    return c1 * np.sqrt(inner) + c2 * inner


def bound_asymptotic(n: int, epsilons: Sequence[float], c1b: float,
                     c2b: float) -> float:
    """Large-T bound, eqs. (10)/(11)."""
    S = budget_sum(epsilons)
    return c1b / n * np.sqrt(S) + c2b / n ** 2 * S


def fit_constants(ns: np.ndarray, eps_sums: np.ndarray, observed: np.ndarray,
                  nonneg: bool = True) -> Tuple[float, float]:
    """Least-squares fit of (c1bar, c2bar) in eq. (11) to observed CoP.

    Design: observed ~= c1b * sqrt(S)/n + c2b * S/n^2.
    """
    x1 = np.sqrt(eps_sums) / ns
    x2 = eps_sums / ns ** 2
    X = np.stack([x1, x2], axis=1)
    coef, *_ = np.linalg.lstsq(X, observed, rcond=None)
    if nonneg:
        coef = np.maximum(coef, 0.0)
        # refit the active coordinate if one was clipped
        if coef[0] == 0.0:
            coef[1] = max(float(np.linalg.lstsq(X[:, 1:], observed,
                                                rcond=None)[0][0]), 0.0)
        elif coef[1] == 0.0:
            coef[0] = max(float(np.linalg.lstsq(X[:, :1], observed,
                                                rcond=None)[0][0]), 0.0)
    return float(coef[0]), float(coef[1])


def min_owners_for_benefit(psi_isolated: float, n_per_owner: int,
                           epsilon: float, c1b: float, c2b: float,
                           max_n: int = 4096) -> int:
    """Smallest N such that the predicted private-collaboration CoP beats
    training alone without privacy (the black region of Fig. 6)."""
    for N in range(1, max_n + 1):
        eps = [epsilon] * N
        if bound_asymptotic(N * n_per_owner, eps, c1b, c2b) < psi_isolated:
            return N
    return -1
