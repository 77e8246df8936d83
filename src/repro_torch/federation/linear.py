"""The paper's convex learning problem (Section 5): ridge linear regression.

Counterpart of ``repro/federation/linear.py``.

    f(theta) = reg * ||theta||^2 + (1/n) sum_j ||y_j - theta^T x_j||^2

Per-owner gradient queries (eq. 3) reduce to Gram-matrix form
    Q_i(theta) = 2 (A_i theta - b_i),   A_i = X_i^T X_i / n_i,  b_i = X_i^T y_i / n_i
so each Algorithm-1 iteration is O(p^2) regardless of n_i. The bound Xi
(Assumption 2) is computed from public data bounds; because it is a true
upper bound, per-record clipping never binds and the Gram shortcut is exact.

`make_problem` sums in numpy f64, as the reference does, and stores f32
tensors (the reference's ``jnp.asarray`` with x64 off) on `device`, CUDA
when None. `fitness` and `relative_fitness` take a (p,) theta or a batch
(..., p) of them.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class Owner(NamedTuple):
    A: torch.Tensor     # (p, p) = X^T X / n
    b: torch.Tensor     # (p,)   = X^T y / n
    n: int
    xi: float           # per-record gradient norm bound for this owner


class LinearProblem(NamedTuple):
    G: torch.Tensor     # (p, p) global X^T X / n
    h: torch.Tensor     # (p,)   global X^T y / n
    c: torch.Tensor     # ()     mean y^2
    reg: float
    theta_max: float
    theta_star: torch.Tensor
    f_star: torch.Tensor
    n_total: int
    xi: float           # global Xi = max_i xi_i

    def to(self, device) -> "LinearProblem":
        """The same problem with its tensors on `device`."""
        return self._replace(**{f: getattr(self, f).to(device)
                                for f in ("G", "h", "c", "theta_star", "f_star")})


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def record_grad_bound(X: np.ndarray, y: np.ndarray, theta_max: float) -> float:
    """Xi = sup_theta max_j ||grad l_j||_2 <= 2 max_j ||x_j|| (theta_max ||x_j||_1 + |y_j|)."""
    xn2 = np.linalg.norm(X, axis=1)
    xn1 = np.abs(X).sum(axis=1)
    return float(2.0 * np.max(xn2 * (theta_max * xn1 + np.abs(y))))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def fitness(prob: LinearProblem, theta: torch.Tensor) -> torch.Tensor:
    quad = _dot(theta @ prob.G, theta) - 2.0 * (theta @ prob.h) + prob.c
    return prob.reg * _dot(theta, theta) + quad


def relative_fitness(prob: LinearProblem, theta: torch.Tensor) -> torch.Tensor:
    """psi(theta) = f(theta)/f(theta*) - 1 >= 0 (Section 5)."""
    return fitness(prob, theta) / prob.f_star - 1.0


def owner_grad(owner: Owner, theta: torch.Tensor) -> torch.Tensor:
    """Q_i(theta) of eq. (3) for the squared loss."""
    return 2.0 * (owner.A @ theta - owner.b)


def reg_grad(prob: LinearProblem, theta: torch.Tensor) -> torch.Tensor:
    return theta * (2.0 * prob.reg)


def make_problem(shards: List[Tuple[np.ndarray, np.ndarray]], *,
                 reg: float = 1e-5, theta_max: float = 10.0, device=None
                 ) -> Tuple[LinearProblem, List[Owner]]:
    """shards: [(X_i, y_i)] per owner. The tensors go to `device` (CUDA when
    None)."""
    device = resolve_device(device)
    p = shards[0][0].shape[1]
    owners = []
    G = np.zeros((p, p))
    h = np.zeros(p)
    c = 0.0
    n_total = sum(X.shape[0] for X, _ in shards)
    for X, y in shards:
        n_i = X.shape[0]
        A = X.T @ X / n_i
        b = X.T @ y / n_i
        xi = record_grad_bound(X, y, theta_max)
        owners.append(Owner(_f32(A, device), _f32(b, device), n_i, xi))
        G += X.T @ X
        h += X.T @ y
        c += float(y @ y)
    G, h, c = G / n_total, h / n_total, c / n_total
    theta_star = np.linalg.solve(G + reg * np.eye(p), h)
    if np.max(np.abs(theta_star)) > theta_max:
        raise AssertionError(
            "theta_max too small: unconstrained optimum outside Theta "
            f"(max |theta*| = {np.max(np.abs(theta_star)):.3f})")
    f_star = reg * theta_star @ theta_star + (
        theta_star @ G @ theta_star - 2 * theta_star @ h + c)
    prob = LinearProblem(_f32(G, device), _f32(h, device), _f32(c, device),
                         reg, theta_max, _f32(theta_star, device),
                         _f32(f_star, device), n_total,
                         max(o.xi for o in owners))
    return prob, owners
