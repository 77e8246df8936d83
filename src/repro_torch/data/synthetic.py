"""Synthetic stand-ins for the paper's datasets (an own numpy copy of
repro/data/synthetic.py: the same generators, draw for draw).

`lending`  — mimics the Lending Club interest-rate regression (Sec. 5.1):
             ~10 post-PCA features (decaying variance like PCA components),
             target = linear signal + noise, mildly heavy-tailed.
`health`   — mimics NY SPARCS length-of-stay (Sec. 5.2): mixed
             categorical-coded integer features + skewed positive target.

Both generators produce data whose *scale statistics* (feature variances,
target variance) are fixed and documented so Xi bounds and the fitted
Theorem-2 constants are stable across seeds.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def lending(n: int, seed: int = 0, p: int = 10,
            theta_shift: np.ndarray = None) -> Tuple[np.ndarray, np.ndarray]:
    """Post-PCA features are normalized (the paper runs PCA "to improve
    numerical stability"), so feature magnitudes — and hence the gradient
    bound Xi — are O(1-10), matching the noise regime of Figs. 4-6."""
    rng = np.random.default_rng(seed)
    # PCA-like spectrum: component i has std ~ 0.3/sqrt(1+i)
    stds = 0.3 / np.sqrt(1.0 + np.arange(p))
    X = rng.normal(size=(n, p)) * stds
    X = np.clip(X, -1.0, 1.0)                    # bounded features (public)
    theta_true = rng.uniform(-1.0, 1.0, size=p)
    if theta_shift is not None:
        theta_true = theta_true + theta_shift
    y = X @ theta_true + 0.1 * rng.standard_t(df=6, size=n)
    y = np.clip(y, -2.0, 2.0)
    return X.astype(np.float64), y.astype(np.float64)


def health(n: int, seed: int = 0, p: int = 10,
           theta_shift: np.ndarray = None) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed + 7919)
    # integer-coded categorical-ish features, normalized
    levels = rng.integers(2, 12, size=p)
    X = np.stack([rng.integers(0, lv, size=n) / lv for lv in levels], axis=1)
    X = 0.5 * (X - X.mean(axis=0, keepdims=True))
    theta_true = rng.uniform(0.0, 1.5, size=p)
    if theta_shift is not None:
        theta_true = theta_true + theta_shift
    los = np.exp(0.5 * (X @ theta_true)) + rng.gamma(2.0, 0.3, size=n)
    y = np.clip(los, 0.0, 3.0)                   # length of stay (normalized)
    return X.astype(np.float64), y.astype(np.float64)


GENERATORS = {"lending": lending, "health": health}


def owner_shards(dataset: str, sizes: List[int], seed: int = 0, p: int = 10,
                 heterogeneity: float = 0.3
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-owner shards with owner-level distribution shift.

    Real collaborating institutions (the paper's banks/hospitals) have
    different local y|x relationships; ``heterogeneity`` scales a per-owner
    perturbation of the generating coefficients. This is what makes the
    isolated single-owner model genuinely worse on the GLOBAL fitness
    (Fig. 6/7's psi(theta_1*) markers sit well above 0). heterogeneity=0
    recovers IID shards.
    """
    rng = np.random.default_rng(seed + 101)
    gen = GENERATORS[dataset]
    shards = []
    for i, s in enumerate(sizes):
        shift = heterogeneity * rng.normal(size=p)
        shards.append(gen(s, seed=seed + 13 * i, p=p, theta_shift=shift))
    return shards


def token_batch(rng, batch: int, seq: int, vocab: int):
    """Synthetic LM batch for deep-model examples and benchmarks: tokens
    (batch, seq) int32 uniform in [0, vocab) from `rng` (a seed or a numpy
    Generator), labels the tokens shifted left by one (rolled)."""
    rng = np.random.default_rng(rng)
    toks = rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
