"""Privacy Mechanisms: noise calibration WITH the ledger inside.

Counterpart of ``repro/federation/mechanisms.py``. A mechanism calibrates
every owner's Laplace scale AND ledgers every authorized response in its
PrivacyAccountant, so accounting cannot drift from the noise emitted;
budget-exhausted owners are refused here.

  'paper'            — Theorem 1's exact scale b_i = 2 Xi T / (n_i eps_i).
  'strict'           — the same times sqrt(p): the paper takes the L2 bound
                       Xi as the L1 sensitivity, which sqrt(p) makes true
                       for a p-dimensional query (p is required).
  'per_owner_rounds' — owners enforce a response cap R = ceil(slack*T/N),
                       so the same eps_i holds at 2 Xi R / (n_i eps_i).
  'tree'             — DP-FTRL binary-tree correlated noise (Kairouz et
                       al. 2021): per-node scale d * b(R) at R = min(T,
                       2^d - 1), the enforced cap. The node tensor lives
                       in the engine's state (deep.TreeNoise).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.federation.config import FederationConfig
from repro_torch.federation.owners import DataOwner
from repro_torch.federation.privacy import (DeviceLedger, PrivacyAccountant,
                                            laplace_scale_theorem1)


# the device ledger's counting columns, in the order reconcile reads them
_COLUMNS = ("spent", "refused", "dropped", "faulted", "quarantined", "timed_out", "retried")


class LedgerDriftError(RuntimeError):
    """The device ledger and the host accountant disagree (raised by
    reconcile() instead of absorbing the mismatch)."""


class _LedgeredMechanism:
    """Shared ledger plumbing for the Theorem-1 mechanism family."""

    name = "base"

    def __init__(self, owners: Sequence[DataOwner], cfg: FederationConfig, *,
                 composition: str = "paper", cap_slack: float = 2.0,
                 tree_depth: Optional[int] = None):
        self.owners = list(owners)
        self.cfg = cfg
        self._accountant = PrivacyAccountant(
            {i: o.epsilon for i, o in enumerate(self.owners)}, cfg.horizon,
            composition=composition, cap_slack=cap_slack, n_owners=len(self.owners),
            tree_depth=tree_depth)
        n = len(self.owners)
        self.refusals = {i: 0 for i in range(n)}
        # fault and staleness outcomes. None touches the accountant:
        # dropped, quarantined and retried rounds produced no response (no
        # epsilon), and faulted and timed-out rounds are already in the
        # spent count (epsilon is charged when the owner answers)
        self.dropped_rounds = {i: 0 for i in range(n)}
        self.faulted_rounds = {i: 0 for i in range(n)}
        self.quarantined_rounds = {i: 0 for i in range(n)}
        self.timed_out_rounds = {i: 0 for i in range(n)}
        self.retried_rounds = {i: 0 for i in range(n)}
        # device counters already folded back by reconcile(), one dict per
        # device column: deltas against these make reconcile idempotent
        # over chunked dispatches
        self._folded = {col: {i: 0 for i in range(n)} for col in _COLUMNS}
        self._snapshot_sid = 0

    def _tallies(self, col: str) -> Dict[int, int]:
        """The host tally a device column folds into (`spent` has none: it
        folds into the accountant)."""
        return self.refusals if col == "refused" else getattr(self, f"{col}_rounds")

    @property
    def cap(self) -> Optional[int]:
        """Per-owner response cap the engine enforces (None = T)."""
        return self._accountant.ledgers[0].cap if self.owners else None

    def effective_horizon(self) -> int:
        c = self.cap
        return c if c is not None else self.cfg.horizon

    def _scale_one(self, owner: DataOwner, p: Optional[int], xi: float) -> float:
        raise NotImplementedError

    def scales(self, p: Optional[int] = None, clip_norm: Optional[float] = None,
               device=None) -> torch.Tensor:
        """(N,) f32 per-owner noise scales. `p` is the query dimension
        (dimension-aware mechanisms need it: 'strict'). `clip_norm`
        overrides each owner's Xi_i as the sensitivity bound (the deep path
        passes its ENFORCED clip norm). On `device`, CUDA when None."""
        return torch.tensor([
            0.0 if self.cfg.noiseless else
            self._scale_one(o, p, clip_norm if clip_norm is not None else o.xi)
            for o in self.owners], dtype=torch.float32, device=resolve_device(device))

    def authorize(self, owner_idx: int) -> bool:
        ok = self._accountant.record_response(int(owner_idx))
        if not ok:
            self.refusals[int(owner_idx)] += 1
        return ok

    def exhausted(self, owner_idx: int) -> bool:
        """Is the owner's budget spent? (A peek: no refusal is recorded.)"""
        return self._accountant.ledgers[int(owner_idx)].exhausted

    def record_dropped(self, owner_idx: int) -> None:
        """Tally a round lost BEFORE the owner answered (no epsilon)."""
        self.dropped_rounds[int(owner_idx)] += 1

    def record_faulted(self, owner_idx: int) -> None:
        """Tally an answered-then-rejected round (its epsilon was charged by
        authorize(); this records that it bought no progress)."""
        self.faulted_rounds[int(owner_idx)] += 1

    def record_quarantined(self, owner_idx: int) -> None:
        """Tally a round masked because the owner was quarantined (no
        answer, no epsilon, no refusal)."""
        self.quarantined_rounds[int(owner_idx)] += 1

    def record_timed_out(self, owner_idx: int) -> None:
        """Tally a round answered past the deadline (its epsilon was charged
        by authorize(); the answer came too late to apply)."""
        self.timed_out_rounds[int(owner_idx)] += 1

    def record_retried(self, owner_idx: int) -> None:
        """Tally a round masked while the owner sat in retry backoff (never
        dispatched: no answer, no epsilon, no refusal)."""
        self.retried_rounds[int(owner_idx)] += 1

    def authorize_many(self, owner_idx: int, count: int) -> int:
        granted = self._accountant.record_responses(int(owner_idx), int(count))
        self.refusals[int(owner_idx)] += int(count) - granted
        return granted

    def ledger(self) -> Dict[int, Dict]:
        summary = self._accountant.summary()
        for i in self.refusals:
            for col in _COLUMNS[1:]:
                summary[i][col] = self._tallies(col)[i]
        return summary

    def device_ledger(self, device=None) -> DeviceLedger:
        """Snapshot the accountant as a DeviceLedger with a fresh generation
        id, every column seeded from the current host totals; only the
        latest snapshot's state chain may reconcile."""
        device = resolve_device(device)
        self._snapshot_sid += 1
        n = len(self.owners)
        led = self._accountant.device_ledger(device)
        led = led.replace(sid=self._snapshot_sid, **{
            col: torch.tensor([self._tallies(col)[i] for i in range(n)], dtype=torch.int32,
                              device=device) for col in _COLUMNS[1:]})
        for i in range(n):
            self._folded["spent"][i] = self._accountant.ledgers[i].responses
            for col in _COLUMNS[1:]:
                self._folded[col][i] = self._tallies(col)[i]
        return led

    def reconcile(self, ledger: DeviceLedger) -> Dict[int, Dict]:
        """Fold the device counters back into the host accountant; any
        disagreement (a device grant the host cap refuses, or a column that
        went backwards) raises LedgerDriftError and leaves the accountant
        untouched (validate, then apply). The seven columns come back in
        one device->host copy."""
        cols = torch.stack([getattr(ledger, col) for col in _COLUMNS]).cpu().numpy()
        n = len(self.owners)
        if cols.shape[1:] != (n,):
            raise ValueError(f"device ledger for {cols.shape[1]} owners, "
                             f"mechanism has {n}")
        if ledger.sid != self._snapshot_sid:
            raise LedgerDriftError(
                f"state ledger is from snapshot {ledger.sid}, but the live "
                f"snapshot is {self._snapshot_sid}: a newer init_state()/"
                "device_ledger() superseded this state")
        deltas = []
        for i in range(n):
            d = {col: int(cols[c, i]) - self._folded[col][i] for c, col in enumerate(_COLUMNS)}
            if min(d.values()) < 0:
                raise LedgerDriftError(
                    f"owner {i}: device counters went backwards (spent "
                    f"{cols[0, i]} < folded {self._folded['spent'][i]}, refused "
                    f"{cols[1, i]} < {self._folded['refused'][i]}, or a fault-outcome "
                    "column shrank)")
            led_i = self._accountant.ledgers[i]
            room = led_i.effective_horizon - led_i.responses
            if d["spent"] > room:
                raise LedgerDriftError(
                    f"owner {i}: device granted {d['spent']} responses but the "
                    f"host cap admits only {max(0, room)}; the state ledger is "
                    "stale (host-authorized rounds ran after the snapshot)")
            deltas.append(d)
        for i, d in enumerate(deltas):
            self._accountant.record_responses(i, d["spent"])
            # the outcome columns carry no epsilon of their own: they fold
            # into the host tallies without touching the accountant
            for col in _COLUMNS[1:]:
                self._tallies(col)[i] += d[col]
            for c, col in enumerate(_COLUMNS):
                self._folded[col][i] = int(cols[c, i])
        return self.ledger()


class PaperMechanism(_LedgeredMechanism):
    name = "paper"

    def _scale_one(self, owner: DataOwner, p: Optional[int], xi: float) -> float:
        return laplace_scale_theorem1(xi, self.cfg.horizon, owner.n, owner.epsilon)


class StrictMechanism(_LedgeredMechanism):
    name = "strict"

    def _scale_one(self, owner: DataOwner, p: Optional[int], xi: float) -> float:
        if p is None:
            raise ValueError("strict L1 slack needs the query dimension p")
        return laplace_scale_theorem1(xi, self.cfg.horizon, owner.n, owner.epsilon,
                                      p=p, l1_slack="strict")


class CappedRoundsMechanism(_LedgeredMechanism):
    name = "per_owner_rounds"

    def __init__(self, owners, cfg, *, cap_slack: float = 2.0):
        super().__init__(owners, cfg, composition="per_owner_rounds", cap_slack=cap_slack)

    def _scale_one(self, owner: DataOwner, p: Optional[int], xi: float) -> float:
        return laplace_scale_theorem1(xi, self.effective_horizon(), owner.n, owner.epsilon)


class TreeMechanism(_LedgeredMechanism):
    """DP-FTRL binary-tree correlated noise (Kairouz et al. 2021).

    Every response releases the delta of a depth-`tree_depth` noise tree
    (kernels/tree_noise): the cumulative noise of an owner's first t
    responses is popcount(t) node draws instead of t. The per-node scale is
    d * b(R) with R = min(T, 2^d - 1) the tree's leaf capacity, which is
    also the enforced response cap.

    `depth=None` sizes the tree to the horizon (T.bit_length(), capacity
    >= T). Depth 0 is the degenerate tree: independent per-round noise at
    the paper scale, bit for bit the paper mechanism's path. The node
    tensor lives in the engine's state, so this mechanism serves the deep
    engine only."""

    name = "tree"

    def __init__(self, owners, cfg, *, depth: Optional[int] = None):
        if depth is None:
            depth = int(cfg.horizon).bit_length()
        depth = int(depth)
        if depth < 0:
            raise ValueError(f"tree depth must be >= 0, got {depth}")
        if depth > 30:
            raise ValueError(f"tree depth {depth} overflows the int32 "
                             "leaf counters (max 30)")
        self.tree_depth = depth
        super().__init__(owners, cfg, composition="tree", tree_depth=depth)

    @property
    def capacity(self) -> Optional[int]:
        """Leaves the tree holds before refusal (None: degenerate tree)."""
        return None if self.tree_depth == 0 else (1 << self.tree_depth) - 1

    def _scale_one(self, owner: DataOwner, p: Optional[int], xi: float) -> float:
        levels = max(1, self.tree_depth)
        return levels * laplace_scale_theorem1(xi, self.effective_horizon(), owner.n,
                                               owner.epsilon)


_MECHANISMS = {
    "paper": PaperMechanism,
    "strict": StrictMechanism,
    "per_owner_rounds": CappedRoundsMechanism,
    "tree": TreeMechanism,
}


def make_mechanism(spec, owners: Sequence[DataOwner], cfg: FederationConfig, *,
                   cap_slack: Optional[float] = None, tree_depth: Optional[int] = None):
    if not isinstance(spec, str):
        if cap_slack is not None:
            raise ValueError("cap_slack cannot be applied to a pre-built mechanism instance")
        if tree_depth is not None:
            raise ValueError("tree_depth cannot be applied to a pre-built mechanism instance")
        return spec
    try:
        cls = _MECHANISMS[spec]
    except KeyError:
        raise ValueError(f"unknown mechanism {spec!r}; one of {sorted(_MECHANISMS)}")
    if tree_depth is not None and cls is not TreeMechanism:
        raise ValueError("tree_depth only applies to mechanism='tree'")
    if cls is CappedRoundsMechanism:
        return cls(owners, cfg, cap_slack=2.0 if cap_slack is None else cap_slack)
    if cap_slack is not None:
        raise ValueError("cap_slack only applies to mechanism='per_owner_rounds'")
    if cls is TreeMechanism:
        return cls(owners, cfg, depth=tree_depth)
    return cls(owners, cfg)
