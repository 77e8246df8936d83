"""DataOwner: one private participant of the federation.

Counterpart of ``repro/federation/owners.py``. An owner is (n_i records,
budget eps_i, gradient bound Xi_i) plus an optional convex Gram payload
(A_i, b_i) that unlocks the O(p^2) convex engine. Deep-model owners carry
no payload: their data arrives per round as batches from the host-side
pipeline. `from_arrays` and `federate_problem` put the payload's tensors on
`device`, CUDA when None.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.federation.linear import (LinearProblem, Owner, _f32, make_problem,
                                           record_grad_bound)


@dataclasses.dataclass(frozen=True)
class DataOwner:
    n: int                        # records held (n_i)
    epsilon: float                # privacy budget (eps_i)
    xi: float                     # Assumption-2 gradient-norm bound (Xi_i)
    gram: Optional[Owner] = None  # convex fast-path payload (A_i, b_i)

    @classmethod
    def from_arrays(cls, X: np.ndarray, y: np.ndarray, epsilon: float, *,
                    theta_max: float, device=None) -> "DataOwner":
        """Build a convex owner from its raw records (they never leave the
        owner's side; only the Gram aggregates enter the engine)."""
        device = resolve_device(device)
        n_i = X.shape[0]
        A = _f32(X.T @ X / n_i, device)
        b = _f32(X.T @ y / n_i, device)
        xi = record_grad_bound(X, y, theta_max)
        return cls(n=n_i, epsilon=epsilon, xi=xi, gram=Owner(A, b, n_i, xi))

    @classmethod
    def from_gram(cls, owner: Owner, epsilon: float) -> "DataOwner":
        return cls(n=owner.n, epsilon=epsilon, xi=owner.xi, gram=owner)


def _broadcast_budgets(epsilons: Union[float, Sequence[float]],
                       n_owners: int) -> List[float]:
    if isinstance(epsilons, (int, float)):
        return [float(epsilons)] * n_owners
    epsilons = list(epsilons)
    if len(epsilons) != n_owners:
        raise ValueError(f"{len(epsilons)} budgets for {n_owners} owners")
    return [float(e) for e in epsilons]


def federate_problem(shards: List[Tuple[np.ndarray, np.ndarray]],
                     epsilons: Union[float, Sequence[float]], *,
                     reg: float = 1e-5, theta_max: float = 10.0, device=None
                     ) -> Tuple[LinearProblem, List[DataOwner]]:
    """shards [(X_i, y_i)] + per-owner budgets -> (LinearProblem, owners).

    Builds the global problem and the per-owner Gram payloads in one pass
    (a scalar budget is broadcast to every owner), on `device`."""
    prob, gram = make_problem(shards, reg=reg, theta_max=theta_max, device=device)
    eps = _broadcast_budgets(epsilons, len(gram))
    return prob, [DataOwner.from_gram(o, e) for o, e in zip(gram, eps)]


def with_budgets(owners: Sequence[DataOwner],
                 epsilons: Union[float, Sequence[float]]) -> List[DataOwner]:
    """Same owners, renegotiated budgets (Section 6's budget negotiation)."""
    eps = _broadcast_budgets(epsilons, len(owners))
    return [dataclasses.replace(o, epsilon=e) for o, e in zip(owners, eps)]
