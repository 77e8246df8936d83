"""Theorem-1 noise calibration and budget accounting.

Counterpart of ``repro/federation/privacy.py`` (the paper composition).
Theorem 1: over a horizon of at most T query rounds, owner i's responses
are eps_i-DP if each adds i.i.d. Laplace noise of scale

    b_i = 2 * Xi * T / (n_i * eps_i).

`PrivacyAccountant` is the host-side source of truth. `DeviceLedger` is its
device-resident mirror inside the training state: authorization in the
fused multi-round driver is the device predicate ``spent[i] < cap[i]``, so
K rounds run without a host round-trip, and `reconcile` folds the counters
back into the accountant afterwards.

Beyond the paper: `composition="per_owner_rounds"` caps every owner at
R = ceil(slack * T / N) responses (refusal is data-independent, hence
free), so the same eps_i holds at scale 2 Xi R / (n_i eps_i).
`composition="tree"` (DP-FTRL, Kairouz et al. 2021) caps every owner at
the depth-d tree's capacity R = min(T, 2^d - 1); each response enters d
node queries at per-node scale d * b(R). The integer response ledger is
the same in every composition (each grant costs eps/R), so reconciling
the device ledger needs no tree arithmetic; `summary()` adds the
per-level node-completion view of the tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import random
from repro_torch.device import resolve_device
from repro_torch.tree_util import tree_flatten, tree_unflatten


def laplace_scale_theorem1(xi: float, horizon: int, n_records: int,
                           epsilon: float, *, p: Optional[int] = None,
                           l1_slack: str = "paper") -> float:
    """Noise scale b_i of Theorem 1. The paper takes Xi, a bound on the L2
    norm, as the L1 sensitivity; l1_slack="strict" multiplies by sqrt(p),
    which makes it a true L1 bound for a p-dimensional query."""
    if epsilon <= 0:
        raise ValueError("epsilon must be > 0")
    b = 2.0 * xi * horizon / (n_records * epsilon)
    if l1_slack == "strict":
        if p is None:
            raise ValueError("strict L1 slack needs the dimension p")
        b *= math.sqrt(p)
    elif l1_slack != "paper":
        raise ValueError(l1_slack)
    return b


def capped_rounds(horizon: int, n_owners: int, slack: float = 2.0) -> int:
    """Response cap R_i of the per-owner-rounds composition."""
    return max(1, math.ceil(slack * horizon / n_owners))


def laplace_noise(key: torch.Tensor, shape, scale) -> torch.Tensor:
    """scale * jax.random.laplace(key, shape) in f32; `scale` a float or a
    0-d tensor on the key's device."""
    return scale * random.laplace(key, shape)


def laplace_noise_tree(key: torch.Tensor, tree: Any, scale) -> Any:
    """Laplace(scale) noise shaped like `tree`: one `split(key, n_leaves)`
    and leaf i draws from key i, leaves in jax's order, each cast to its
    leaf's dtype."""
    leaves, treedef = tree_flatten(tree)
    keys = random.split(key, len(leaves))
    return tree_unflatten(treedef, [laplace_noise(k, leaf.shape, scale).to(leaf.dtype)
                                    for k, leaf in zip(keys, leaves)])


_FAULT_COLUMNS = ("dropped", "faulted", "quarantined", "timed_out", "retried")


class DeviceLedger:
    """Device-resident mirror of the accountant's counters.

    `spent` (N,) int32 counts responses granted on the device (seeded from
    the host accountant), `cap` (N,) int32 is the per-owner response cap,
    `refused` (N,) int32 counts device refusals. `sid` is the snapshot
    generation: `reconcile` only accepts the lineage of the latest
    `device_ledger()` snapshot, so two live states of one session cannot
    fold divergent counters against one baseline. The drivers update the
    counters in place, so every column is its own buffer.

    The fault and staleness columns (epsilon is charged when the owner
    ANSWERS): `spent` counts every answered round, also one a guard then
    rejected. `dropped` counts rounds lost before the answer (no epsilon);
    `faulted` answered-then-rejected rounds (non-finite update, checksum
    mismatch, stale replay; a subset of spent's increments); `quarantined`
    rounds masked because the owner was quarantined (no epsilon, no
    refusal); `timed_out` rounds answered past the deadline (epsilon
    spent, a subset of spent's increments); `retried` rounds masked while
    the owner sat in its retry backoff (never dispatched, no epsilon)."""

    # the eight columns in the order the reference's pytree flattens them
    # (a checkpoint keys them ledger/0 ... ledger/7)
    COLUMNS = ("spent", "cap", "refused") + _FAULT_COLUMNS

    def __init__(self, spent: torch.Tensor, cap: torch.Tensor,
                 refused: torch.Tensor, dropped: Optional[torch.Tensor] = None,
                 faulted: Optional[torch.Tensor] = None,
                 quarantined: Optional[torch.Tensor] = None,
                 timed_out: Optional[torch.Tensor] = None,
                 retried: Optional[torch.Tensor] = None, sid: int = 0):
        self.spent = spent
        self.cap = cap
        self.refused = refused
        # a distinct zero buffer per absent column
        self.dropped = torch.zeros_like(spent) if dropped is None else dropped
        self.faulted = torch.zeros_like(spent) if faulted is None else faulted
        self.quarantined = torch.zeros_like(spent) if quarantined is None else quarantined
        self.timed_out = torch.zeros_like(spent) if timed_out is None else timed_out
        self.retried = torch.zeros_like(spent) if retried is None else retried
        self.sid = sid

    def replace(self, **kw) -> "DeviceLedger":
        fields = {"spent": self.spent, "cap": self.cap, "refused": self.refused,
                  **{c: getattr(self, c) for c in _FAULT_COLUMNS}, "sid": self.sid}
        fields.update(kw)
        return DeviceLedger(**fields)

    def authorized(self, owner_idx: torch.Tensor) -> torch.Tensor:
        """0-d bool device tensor: may `owner_idx` (a (1,) int64 device
        index) answer one more query? No host sync."""
        return (self.spent.index_select(0, owner_idx)
                < self.cap.index_select(0, owner_idx)).reshape(())


def make_device_ledger(caps: Sequence[int], spent: Optional[Sequence[int]] = None,
                       refused: Optional[Sequence[int]] = None,
                       dropped: Optional[Sequence[int]] = None,
                       faulted: Optional[Sequence[int]] = None,
                       quarantined: Optional[Sequence[int]] = None,
                       timed_out: Optional[Sequence[int]] = None,
                       retried: Optional[Sequence[int]] = None, sid: int = 0,
                       device=None) -> DeviceLedger:
    """Device counters on `device` (CUDA when None)."""
    device = resolve_device(device)
    caps = torch.tensor(list(caps), dtype=torch.int32, device=device)

    def col(v):
        # a distinct buffer per column: the drivers update them in place
        return (torch.zeros_like(caps) if v is None
                else torch.tensor(list(v), dtype=torch.int32, device=device))

    return DeviceLedger(spent=col(spent), cap=caps, refused=col(refused),
                        dropped=col(dropped), faulted=col(faulted),
                        quarantined=col(quarantined), timed_out=col(timed_out),
                        retried=col(retried), sid=sid)


@dataclasses.dataclass
class OwnerLedger:
    epsilon: float
    horizon: int
    responses: int = 0
    cap: Optional[int] = None        # None -> paper composition (cap = T)

    @property
    def effective_horizon(self) -> int:
        return self.cap if self.cap is not None else self.horizon

    @property
    def spent(self) -> float:
        """Budget consumed so far (eps_i/T_eff per response)."""
        return self.responses * self.epsilon / self.effective_horizon

    @property
    def exhausted(self) -> bool:
        return self.responses >= self.effective_horizon


class PrivacyAccountant:
    """Tracks per-owner budget spend across the training horizon: every
    owner may answer at most its effective horizon (T in the paper
    composition, the cap in the others)."""

    def __init__(self, epsilons: Dict[int, float], horizon: int,
                 composition: str = "paper", cap_slack: float = 2.0,
                 n_owners: Optional[int] = None, tree_depth: Optional[int] = None):
        if composition not in ("paper", "per_owner_rounds", "tree"):
            raise ValueError(composition)
        cap = None
        if composition == "per_owner_rounds":
            cap = capped_rounds(horizon, n_owners or len(epsilons), cap_slack)
        elif composition == "tree":
            # a depth-d tree holds 2^d - 1 leaves: past that the binary
            # counter has no level for the fresh node, so the cap is also
            # the bound the engine refuses at. Depth 0 is the degenerate
            # tree: the paper cap (T).
            if tree_depth is None:
                raise ValueError("tree composition needs tree_depth")
            if tree_depth > 0:
                cap = min(horizon, (1 << tree_depth) - 1)
        elif tree_depth is not None:
            raise ValueError("tree_depth only applies to composition='tree'")
        self.ledgers = {i: OwnerLedger(e, horizon, cap=cap) for i, e in epsilons.items()}
        self.composition = composition
        self.tree_depth = tree_depth

    def record_response(self, owner: int) -> bool:
        """Returns True if the owner may respond (budget remains)."""
        led = self.ledgers[owner]
        if led.exhausted:
            return False
        led.responses += 1
        return True

    def record_responses(self, owner: int, count: int) -> int:
        """Grant up to `count` responses; returns how many were granted."""
        led = self.ledgers[owner]
        granted = max(0, min(count, led.effective_horizon - led.responses))
        led.responses += granted
        return granted

    def summary(self) -> Dict[int, Dict]:
        out = {i: {"epsilon": led.epsilon, "responses": led.responses,
                   "spent": led.spent, "exhausted": led.exhausted}
               for i, led in self.ledgers.items()}
        if self.composition == "tree" and (self.tree_depth or 0) > 0:
            d = self.tree_depth
            for i, led in self.ledgers.items():
                # the tree-completion view of the same integer spend: after
                # t leaves level l has completed t >> l nodes, and each
                # response enters d node queries at eps/(d*R) each, which
                # recomposes to the eps/R per response the ledger charges
                r = led.effective_horizon
                out[i]["tree"] = {
                    "depth": d,
                    "capacity": (1 << d) - 1,
                    "nodes_completed_per_level": [led.responses >> lvl for lvl in range(d)],
                    "eps_per_node": led.epsilon / (d * r),
                }
        return out

    def device_ledger(self, device=None) -> DeviceLedger:
        """Snapshot the counters as a DeviceLedger (owners 0..N-1 dense),
        `spent` seeded from the current response counts and `cap` from the
        effective horizons."""
        idx = sorted(self.ledgers)
        if idx != list(range(len(idx))):
            raise ValueError("device ledger needs dense owner ids 0..N-1")
        return make_device_ledger(caps=[self.ledgers[i].effective_horizon for i in idx],
                                  spent=[self.ledgers[i].responses for i in idx],
                                  device=device)
