"""The fault layer: injection, guards, checksums and quarantine, on the device.

Counterpart of ``repro/federation/faults.py``. The paper's owners are
intermittently available; deployments add failure modes on top of mere
absence: dropped contacts, stale replays, non-finite gradients and
corrupted payloads. This module models them deterministically, so every
driver (the per-round step, the K-round loop, the grouped driver) sees the
same fault sequence under fixed keys, and the DP accounting stays exact
through faults:

  * `FaultPlan` draws one int8 fault code per round from its own key
    stream (``fold_in(key, FAULT_SALT)``, disjoint from the round keys), or
    a recorded trace replays through `as_fault_codes`.
  * `FaultState` rides in ``AsyncDPState.faults``: a per-owner int32
    checksum of the owner's bank row, tumbling fault-window counters and a
    quarantine flag. Every update is masked, so a faulted round is a
    bit-exact no-op on the bank, the scales, the error-feedback residual
    and the noise trees.
  * epsilon is charged when the owner answers: a DROP spends nothing; a
    round that answered and was rejected by a guard has spent its budget.
  * an owner with `FaultPolicy.max_faults` fault events inside one
    `window` of its contacts is quarantined: its later rounds are masked
    no-ops, ledgered in the `quarantined` column.

Checksums are int32 sums of the row's bits, wrapping mod 2^32 as XLA's
int32 sums do. Wrapping addition is associative and commutative, so the
port sums in int64 (a chunk of the row at a time, which bounds the
transient) and reduces mod 2^32 once: the same bits in any order.
Corruption never touches the payload: it offsets the OBSERVED checksum by
a fixed nonzero delta, so detection is certain.

The functions that update a `FaultState` (`update_checksum`,
`fault_tick`) write its tensors IN PLACE and return the state, as the
drivers update the bank and the ledger in place.

On a paged bank (`flatten.PagedBank`) the payload is the hot slot's row
and the checksum column stays per owner: `verify_row` and
`update_checksum` take the slot as `row_idx`, and `init_fault_state`
tiles one row's sum over the (N,) column (every row, hot, cold or never
written, is the default row at init), never an O(N*P) pass. A row's bits
round-trip the cold tier exactly, so it keeps its checksum across an
eviction and a reload.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random
from repro_torch.device import resolve_device
from repro_torch.federation.flatten import PagedBank, ParamFlat, QuantBank
from repro_torch.tree_util import tree_flatten, tree_map

# per-round fault codes (int8 on the device, plain ints here)
OK = 0                  # healthy round
DROP = 1                # owner unreachable: the query was never answered, no eps
STALE = 2               # owner answered with a stale (replayed) update
NONFINITE_GRAD = 3      # owner answered with a non-finite update
CORRUPT_PAYLOAD = 4     # owner's resident bank row arrived corrupted
TIMEOUT = 5             # owner answered AFTER the learner's deadline: eps
                        # spent, update masked (see federation.staleness)

FAULT_CODES = (OK, DROP, STALE, NONFINITE_GRAD, CORRUPT_PAYLOAD, TIMEOUT)

# the fault draws' own fold_in stream, disjoint from the round keys
FAULT_SALT = 0x4654     # "FT"

# added to the OBSERVED checksum of a CORRUPT_PAYLOAD round: nonzero mod
# 2^32, so the mismatch is certain and the payload is never modified
CORRUPT_CSUM_DELTA = 1 << 30

# elements of a row widened to int64 at a time (a 256 MB transient)
_CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-round fault rates, drawn once per dispatch from a salted key.

    The rates are bucket probabilities over [0, 1): one uniform per round
    picks DROP / STALE / NONFINITE_GRAD / CORRUPT_PAYLOAD / OK by
    cumulative thresholds, so every driver sees the same code stream under
    the same key."""

    drop: float = 0.0
    stale: float = 0.0
    nonfinite: float = 0.0
    corrupt: float = 0.0

    def __post_init__(self):
        rates = (self.drop, self.stale, self.nonfinite, self.corrupt)
        if any(r < 0.0 for r in rates):
            raise ValueError(f"fault rates must be >= 0, got {rates}")
        if sum(rates) > 1.0:
            raise ValueError(
                f"fault rates sum to {sum(rates)} > 1; they are bucket "
                "probabilities over a single per-round uniform")

    def draw(self, key: torch.Tensor, k: int) -> torch.Tensor:
        """(k,) int8 fault codes on the key's device, from the FAULT_SALT
        stream: jax.random.uniform on fold_in(key, FAULT_SALT), bucketed
        by the cumulative rates (summed in Python floats, compared in f32,
        as the reference compares them)."""
        u = random.uniform(random.fold_in(key, FAULT_SALT), (k,))
        t1 = self.drop
        t2 = t1 + self.stale
        t3 = t2 + self.nonfinite
        t4 = t3 + self.corrupt
        codes = torch.full((k,), OK, dtype=torch.int8, device=key.device)
        # from the last bucket to the first, so the lowest threshold wins
        for t, code in ((t4, CORRUPT_PAYLOAD), (t3, NONFINITE_GRAD), (t2, STALE), (t1, DROP)):
            thr = torch.full((), t, dtype=torch.float32, device=key.device)
            codes = torch.where(u < thr, torch.full_like(codes, code), codes)
        return codes


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Quarantine policy: `max_faults` fault events within one
    `window`-contact tumbling window quarantine the owner (masked no-ops
    from then on, for the rest of the session)."""

    max_faults: int = 3
    window: int = 16

    def __post_init__(self):
        if self.max_faults < 1:
            raise ValueError(f"max_faults must be >= 1, got {self.max_faults}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")


class FaultState(NamedTuple):
    """Per-owner fault-layer tensors carried in ``AsyncDPState.faults``.

    ``checksum``    (N,) int32  bit-sum of each owner's resident bank row
    ``win_faults``  (N,) int32  fault events in the current window
    ``contacts``    (N,) int32  contacts while not quarantined (the windows
                                tumble per owner on this count, so grouped
                                execution moves no window boundary)
    ``quarantined`` (N,) bool   masked out of every later round
    """

    checksum: torch.Tensor
    win_faults: torch.Tensor
    contacts: torch.Tensor
    quarantined: torch.Tensor


def _bits32(t: torch.Tensor) -> torch.Tensor:
    """The bit pattern of `t` as int32 values, as the reference's _bits32:
    f32 bit-cast, 2-byte data widened through its unsigned pattern, 1-byte
    codes (int8, or fp8 patterns) through uint8, other integers cast."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.element_size() == 2:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    if t.element_size() == 1:
        return t.view(torch.uint8).to(torch.int32)
    return t.to(torch.int32)


def _wrap32(total: torch.Tensor) -> torch.Tensor:
    """An int64 sum reduced mod 2^32 into int32 (two's complement)."""
    return (torch.remainder(total + (1 << 31), 1 << 32) - (1 << 31)).to(torch.int32)


def _row_sum64(t: torch.Tensor, owner_idx: torch.Tensor) -> torch.Tensor:
    """() int64 sum of the bit patterns of row `owner_idx` ((1,) int64
    device index) of `t`, whose leading axis is the owners. The row is
    gathered and widened a chunk at a time, so the transient stays a chunk
    long and no index is read back to the host."""
    flat = t.reshape(t.shape[0], -1)
    total = None
    for s in range(0, flat.shape[1], _CHUNK):
        part = _bits32(flat[:, s:s + _CHUNK].index_select(0, owner_idx)).sum(dtype=torch.int64)
        total = part if total is None else total + part
    if total is None:
        total = torch.zeros((), dtype=torch.int64, device=t.device)
    return total


def row_checksum(bank, owner_idx: torch.Tensor) -> torch.Tensor:
    """() int32 checksum of one owner's resident row (`owner_idx` a (1,)
    int64 device index): the codes plus the scales of a QuantBank (the
    shared residual belongs to no owner and is left out), the row of a
    dense (N, P) bank, or the rows of every leaf of a pytree bank. On a
    PagedBank `owner_idx` is the HOT SLOT (the caller resolves it with
    `bank.lookup`)."""
    if isinstance(bank, PagedBank):
        return row_checksum(bank.hot, owner_idx)
    parts = ((bank.codes, bank.scales) if isinstance(bank, QuantBank)
             else tree_flatten(bank)[0])
    total = _row_sum64(parts[0], owner_idx)
    for t in parts[1:]:
        total = total + _row_sum64(t, owner_idx)
    return _wrap32(total)


def _n_owners(bank) -> int:
    if isinstance(bank, QuantBank):
        return bank.n_owners
    return tree_flatten(bank)[0][0].shape[0]


def _device_of(bank) -> torch.device:
    if isinstance(bank, QuantBank):
        return bank.codes.device
    return tree_flatten(bank)[0][0].device


def bank_checksums(bank) -> torch.Tensor:
    """(N,) int32 checksums of every owner row (init and audit)."""
    dev = _device_of(bank)
    n = _n_owners(bank)
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    return torch.stack([row_checksum(bank, idx[i:i + 1]) for i in range(n)])


def init_fault_state(bank, n_owners: int) -> FaultState:
    """Fresh fault counters beside `bank`: its checksums, zero windows and
    contacts, nobody quarantined (a distinct buffer per field: the drivers
    write them in place). On a PagedBank one row's checksum is tiled over
    the (N,) column: at init every row is the default row."""
    if isinstance(bank, PagedBank):
        dev = _device_of(bank.hot)
        one = row_checksum(bank.hot, torch.zeros(1, dtype=torch.int64, device=dev))
        checksum = one.reshape(1).repeat(n_owners)
    else:
        dev = _device_of(bank)
        checksum = bank_checksums(bank)
    return FaultState(
        checksum=checksum,
        win_faults=torch.zeros(n_owners, dtype=torch.int32, device=dev),
        contacts=torch.zeros(n_owners, dtype=torch.int32, device=dev),
        quarantined=torch.zeros(n_owners, dtype=torch.bool, device=dev))


def _as_bool(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.bool, device=device)


def verify_row(checksum: torch.Tensor, bank, owner_idx: torch.Tensor,
               corrupt, row_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """0-d bool: does the owner's resident row match its stored checksum?

    `corrupt` (CORRUPT_PAYLOAD this round) offsets the OBSERVED sum by
    CORRUPT_CSUM_DELTA, so detection is certain and the payload untouched.
    `row_idx` (a paged bank's hot slot, (1,) int64) is where the payload
    is read; the stored sum is the owner's."""
    obs = row_checksum(bank, owner_idx if row_idx is None else row_idx)
    corrupt = _as_bool(corrupt, obs.device).reshape(())
    obs = torch.where(corrupt, obs + CORRUPT_CSUM_DELTA, obs)
    return obs == checksum.index_select(0, owner_idx).reshape(())


def _leaves_of(tree):
    """The tensors of a ParamFlat (its buffer), a tensor or a tree."""
    if isinstance(tree, ParamFlat):
        return [tree.buf]
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    for part in tree_flatten(tree)[0]:
        out.extend(_leaves_of(part))
    return out


def inject_nonfinite(tree, flag):
    """NaN-poison the float leaves of `tree` where `flag` is set (the same
    bits where it is not). `flag` is 0-d (one round) or (g,) (the members
    of a group, each a leading row of every leaf). `tree` is a tensor, a
    ParamFlat or a tree of tensors."""
    def poison(leaf):
        if not leaf.is_floating_point():
            return leaf
        fl = _as_bool(flag, leaf.device)
        fl = fl.reshape(tuple(fl.shape) + (1,) * (leaf.dim() - fl.dim()))
        return torch.where(fl, torch.full((), float("nan"), dtype=leaf.dtype,
                                          device=leaf.device), leaf)
    if isinstance(tree, ParamFlat):
        return tree.replace_buf(poison(tree.buf))
    if isinstance(tree, torch.Tensor):
        return poison(tree)
    return tree_map(poison, tree)


def finite_guard(tree) -> torch.Tensor:
    """0-d bool: every float leaf of `tree` is entirely finite."""
    ok = None
    for leaf in _leaves_of(tree):
        if leaf.is_floating_point():
            f = torch.isfinite(leaf).all()
            ok = f if ok is None else ok & f
    if ok is None:
        raise ValueError("finite_guard needs a float leaf")
    return ok


def finite_guard_rows(tree) -> torch.Tensor:
    """(g,) bool: member m's rows (the leading axis of every float leaf)
    are entirely finite; `finite_guard` of each member, batched."""
    ok = None
    for leaf in _leaves_of(tree):
        if leaf.is_floating_point():
            f = torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(dim=1)
            ok = f if ok is None else ok & f
    if ok is None:
        raise ValueError("finite_guard_rows needs a float leaf")
    return ok


def _owners(owner_idx: torch.Tensor) -> torch.Tensor:
    return owner_idx.reshape(-1).to(torch.int64)


def _masked_set_(col: torch.Tensor, idx: torch.Tensor, value, mask) -> None:
    """col[idx] = value where mask, in place (idx distinct)."""
    old = col.index_select(0, idx)
    value = torch.as_tensor(value, device=col.device).to(col.dtype).expand_as(old)
    mask = _as_bool(mask, col.device).expand_as(old)
    col.index_copy_(0, idx, torch.where(mask, value, old))


def update_checksum(fs: FaultState, bank, owner_idx: torch.Tensor, apply,
                    row_idx: Optional[torch.Tensor] = None) -> FaultState:
    """Re-derive the stored checksums from the POST-WRITE bank rows of one
    owner ((1,) index, `apply` 0-d) or a group of distinct owners ((g,),
    `apply` (g,)), IN PLACE; where `apply` is False the stored sum stays,
    so a masked round leaves later verification untouched. `row_idx` (the
    hot slots of a paged bank, shaped as `owner_idx`) is where the rows are
    read; the sums land in the owners' column."""
    idx = _owners(owner_idx)
    ridx = idx if row_idx is None else _owners(row_idx)
    new = torch.stack([row_checksum(bank, ridx[m:m + 1]) for m in range(idx.numel())])
    _masked_set_(fs.checksum, idx, new, _as_bool(apply, idx.device).reshape(-1))
    return fs


def fault_tick(fs: FaultState, owner_idx: torch.Tensor, faulted, policy: FaultPolicy,
               active) -> FaultState:
    """Advance the fault window of one owner ((1,) index, flags 0-d) or a
    group of distinct owners ((g,), flags (g,)) after a contact, IN PLACE.

    `active` gates the whole tick: a quarantined owner ticks nothing (its
    window freezes, which makes the quarantine permanent). Windows tumble
    on each owner's own contact count, so grouped execution gives the
    sequential drivers' window boundaries."""
    idx = _owners(owner_idx)
    dev = idx.device
    active = _as_bool(active, dev).reshape(-1).expand(idx.shape)
    faulted = _as_bool(faulted, dev).reshape(-1).expand(idx.shape)
    contacts = fs.contacts.index_select(0, idx)
    base = torch.where(contacts % policy.window == 0, torch.zeros_like(contacts),
                       fs.win_faults.index_select(0, idx))
    wf = base + faulted.to(torch.int32)
    _masked_set_(fs.win_faults, idx, wf, active)
    fs.contacts.index_add_(0, idx, active.to(torch.int32))
    _masked_set_(fs.quarantined, idx, wf >= policy.max_faults, active)
    return fs


def as_fault_codes(codes, k: Optional[int] = None, device=None) -> torch.Tensor:
    """Validate and coerce an explicit per-round fault-code trace to a (K,)
    int8 tensor on `device` (the codes' own device for a tensor, else CUDA
    when None). Checked on the host: 1-D, integer, K long when `k` is
    given, every code one of FAULT_CODES."""
    if isinstance(codes, torch.Tensor):
        dev = codes.device if device is None else resolve_device(device)
        host = codes.detach().cpu().numpy()
    else:
        dev = resolve_device(device)
        host = np.asarray(codes)
    if host.ndim != 1:
        raise ValueError(f"fault codes must be 1-D, got shape {host.shape}")
    if not np.issubdtype(host.dtype, np.integer):
        raise ValueError(f"fault codes must be integer, got {host.dtype}")
    if k is not None and host.shape[0] != k:
        raise ValueError(f"{host.shape[0]} fault codes for a {k}-round dispatch")
    if host.size and (host.min() < OK or host.max() > TIMEOUT):
        raise ValueError(f"fault codes must lie in {FAULT_CODES}, got range "
                         f"[{host.min()}, {host.max()}]")
    return torch.from_numpy(host.astype(np.int8)).to(dev)


__all__ = [
    "OK", "DROP", "STALE", "NONFINITE_GRAD", "CORRUPT_PAYLOAD", "TIMEOUT",
    "FAULT_CODES", "FAULT_SALT", "CORRUPT_CSUM_DELTA",
    "FaultPlan", "FaultPolicy", "FaultState",
    "init_fault_state", "bank_checksums", "row_checksum", "verify_row",
    "inject_nonfinite", "finite_guard", "finite_guard_rows", "update_checksum",
    "fault_tick", "as_fault_codes",
]
