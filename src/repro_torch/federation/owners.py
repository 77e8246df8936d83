"""DataOwner: one private participant of the federation.

Counterpart of ``repro/federation/owners.py`` for deep-model owners: an
owner is (n_i records, budget eps_i, gradient bound Xi_i), and its data
arrives per round as batches from the host-side pipeline. The convex
Gram payload of the reference waits for the convex slice of the port.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DataOwner:
    n: int                       # records held (n_i)
    epsilon: float               # privacy budget (eps_i)
    xi: float                    # Assumption-2 gradient-norm bound (Xi_i)
