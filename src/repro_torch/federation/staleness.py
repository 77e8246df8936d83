"""The asynchronous runtime: latency, deadlines, retries and staleness.

Counterpart of ``repro/federation/staleness.py``. The fault layer models
WHETHER an owner answers; this module models WHEN. Every piece is
deterministic under fixed keys, so the per-round step, the K-round loop
and the grouped driver see the same runtime:

  * `LatencyPlan` draws one response latency per round: a per-owner
    `base` plus an exponential `jitter` from its own key stream
    (``fold_in(key, STALE_SALT)``, disjoint from the round keys and the
    fault codes). The all-zero plan draws nothing.
  * `StalenessPolicy.deadline` turns late responses into the TIMEOUT code
    of the fault algebra (`merge_timeout_codes`): the owner answered, so
    epsilon is spent, but the update is masked. A DROP stays a DROP. With
    per-round arrival instants the deadline tightens to the gap before
    the next round.
  * a timed-out owner backs off: `StalenessState` carries per-owner
    cooldowns and retry budgets. While an owner's cooldown is positive its
    rounds are masked re-dispatches (the ledger's `retried` column, no
    epsilon), each burning one cooldown round.
  * per-owner ages (rounds since the last granted update) give the weight
    ``decay ** age`` (`staleness_weight`): the round runs against
    ``theta_L + w * (theta_i - theta_L)``. decay = 1 is left out of the
    drivers altogether, so the default computes the undecayed round.

Outcome algebra (epsilon when the owner answers):

    round in backoff   -> retried      masked, no epsilon, no refusal
    answered late      -> timed_out    masked, epsilon SPENT
    answered on time   -> the fault guards decide (apply / faulted)
    never answered     -> dropped      no epsilon

Lateness comes before the payload guards (a late corrupt payload counts
as timed_out), and timeouts do not tick the quarantine window.

`staleness_tick` writes the state's tensors IN PLACE and returns it, as
the drivers update the bank and the ledger in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import random
from repro_torch.device import resolve_device
from repro_torch.federation.faults import DROP, TIMEOUT

# the latency draws' own fold_in stream, disjoint from the round keys, the
# fault codes (FAULT_SALT) and the codec bits
STALE_SALT = 0x5354     # "ST"


@dataclasses.dataclass(frozen=True)
class LatencyPlan:
    """Per-owner response-latency model, drawn once per dispatch.

    `base` is the deterministic per-owner floor (a scalar for every owner,
    or a sequence indexed by owner id); `jitter` adds an exponential tail
    of that scale from the STALE_SALT stream. Units are those of the
    schedule's tick times (rounds when no times are in play)."""

    base: Union[float, Sequence[float]] = 0.0
    jitter: float = 0.0

    def __post_init__(self):
        base = np.atleast_1d(np.asarray(self.base, np.float64))
        if base.ndim != 1:
            raise ValueError(f"base must be a scalar or a per-owner "
                             f"vector, got shape {base.shape}")
        if base.size and base.min() < 0.0:
            raise ValueError(f"base latencies must be >= 0, got {base.min()}")
        if self.jitter < 0.0:
            raise ValueError(f"jitter must be >= 0, got {self.jitter}")

    def draw(self, key: torch.Tensor, owner_seq: torch.Tensor) -> torch.Tensor:
        """(K,) f32 latencies for a dispatch's owner sequence, on the key's
        device: the owners' bases plus jitter * Exp(1) from
        fold_in(key, STALE_SALT). A zero-jitter plan draws nothing."""
        dev = key.device
        owner_seq = torch.as_tensor(owner_seq, device=dev).to(torch.int64)
        k = owner_seq.shape[0]
        base = np.asarray(self.base, np.float32)
        if base.ndim == 0:
            lat = torch.full((k,), float(base), dtype=torch.float32, device=dev)
        else:
            lat = torch.from_numpy(base).to(dev).index_select(0, owner_seq)
        if self.jitter:
            u = random.exponential(random.fold_in(key, STALE_SALT), (k,))
            lat = lat + torch.full((), self.jitter, dtype=torch.float32, device=dev) * u
        return lat


@dataclasses.dataclass(frozen=True)
class StalenessPolicy:
    """The learner's runtime policy.

    ``deadline``     responses later than this are TIMEOUT (inf: none is)
    ``max_retries``  per-owner retry budget, refilled on every granted
                     round; past it the owner is served (and times out)
                     without backoff
    ``backoff_cap``  the j-th consecutive timeout waits 2**min(j, cap)
                     scheduled rounds
    ``decay``        lambda of the lambda**age weight; 1.0 (the default)
                     leaves the decay out of the round altogether
    """

    deadline: float = math.inf
    max_retries: int = 0
    backoff_cap: int = 4
    decay: float = 1.0

    def __post_init__(self):
        if not self.deadline > 0.0:
            raise ValueError(f"deadline must be > 0, got {self.deadline}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if not 0 <= self.backoff_cap <= 30:
            raise ValueError(f"backoff_cap must be in [0, 30], got "
                             f"{self.backoff_cap} (int32 cooldowns)")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")


class StalenessState(NamedTuple):
    """Per-owner runtime counters carried in ``AsyncDPState.stale``.

    ``clock``       ()   int32  rounds scheduled so far (every round counts:
                                refused, dropped, retried)
    ``last_grant``  (N,) int32  clock of the owner's last granted update
    ``cooldown``    (N,) int32  scheduled rounds left in backoff
    ``backoff``     (N,) int32  consecutive-timeout exponent
    ``retry_left``  (N,) int32  retry budget left
    """

    clock: torch.Tensor
    last_grant: torch.Tensor
    cooldown: torch.Tensor
    backoff: torch.Tensor
    retry_left: torch.Tensor


def init_staleness_state(n_owners: int, policy: StalenessPolicy,
                         device=None) -> StalenessState:
    """Fresh counters on `device` (CUDA when None), a distinct buffer per
    field (the drivers write them in place)."""
    dev = resolve_device(device)

    def zeros():
        return torch.zeros(n_owners, dtype=torch.int32, device=dev)

    return StalenessState(
        clock=torch.zeros((), dtype=torch.int32, device=dev),
        last_grant=zeros(), cooldown=zeros(), backoff=zeros(),
        retry_left=torch.full((n_owners,), policy.max_retries, dtype=torch.int32,
                              device=dev))


def deadline_guard(fcode: torch.Tensor) -> torch.Tensor:
    """bool: did the response beat the deadline? False exactly on TIMEOUT
    rounds (the response exists, epsilon is spent, but it came too late)."""
    return fcode != TIMEOUT


def merge_timeout_codes(codes, latencies, deadline: float, times=None) -> torch.Tensor:
    """Fold a latency draw into a (K,) fault-code trace: every ANSWERED
    round whose latency exceeds the effective deadline becomes TIMEOUT; a
    DROP stays a DROP. With (K,) non-decreasing arrival instants `times`,
    round k's deadline tightens to min(deadline, times[k+1] - times[k]);
    the last round keeps the policy deadline. On the latencies' device."""
    lat = torch.as_tensor(latencies, dtype=torch.float32)
    dev = lat.device
    codes = torch.as_tensor(codes, device=dev).to(torch.int8)
    if codes.shape != lat.shape:
        raise ValueError(f"{lat.shape[0] if lat.dim() else 0} latencies "
                         f"for {codes.shape[0]} fault codes")
    eff = torch.full(lat.shape, deadline, dtype=torch.float32, device=dev)
    if times is not None:
        times = torch.as_tensor(times, dtype=torch.float32, device=dev)
        if times.shape != lat.shape:
            raise ValueError(f"{tuple(times.shape)} tick times for {tuple(lat.shape)} "
                             "latencies")
        gaps = torch.cat([times[1:] - times[:-1],
                          torch.full((1,), math.inf, dtype=torch.float32, device=dev)])
        eff = torch.minimum(eff, gaps)
    late = (lat > eff) & (codes != DROP)
    return torch.where(late, torch.full_like(codes, TIMEOUT), codes)


def staleness_weight(ss: StalenessState, owner_idx: torch.Tensor, t,
                     policy: StalenessPolicy) -> torch.Tensor:
    """f32 ``decay ** age`` of one owner ((1,) index, `t` the round's 0-d
    clock; a 0-d weight) or a group ((g,) owners, `t` (g,); (g,) weights),
    age = max(t - last_grant, 0). The one helper every driver calls, so
    the drivers agree bit for bit; against XLA's pow it may differ by an
    ulp, and a weight below the smallest normal f32 is 0, as XLA's flushed
    arithmetic gives it. The drivers call it only when decay != 1."""
    last = ss.last_grant.index_select(0, owner_idx.reshape(-1).to(torch.int64))
    t = torch.as_tensor(t, device=last.device)
    age = torch.clamp(t - last, min=0)
    # fills on the device: a tensor built on the host would copy (and sync)
    base = torch.full((), policy.decay, dtype=torch.float32, device=last.device)
    w = torch.pow(base, age.to(torch.float32))
    # below the smallest normal f32 the reference's CPU arithmetic flushes
    # to zero; so does the weight here, on every device
    w = torch.where(w < torch.finfo(torch.float32).tiny, torch.zeros_like(w), w)
    return w.reshape(t.shape)


def staleness_tick(ss: StalenessState, owner_idx: torch.Tensor, t, *, is_retry, apply,
                   timed, policy: StalenessPolicy, active, ticks) -> StalenessState:
    """Advance the runtime counters after a round ((1,) owner, 0-d flags and
    `t`) or a group of DISTINCT owners ((g,), flags and `t` (g,)), IN
    PLACE; `active` masks members, `ticks` is the clock advance (1 a
    round, the group's length for a group).

      * a masked retry burns one cooldown round;
      * a timeout with retry budget left schedules 2**min(backoff, cap)
        cooldown rounds, bumps the exponent and spends one retry;
      * a granted round resets the exponent, refills the retry budget and
        stamps `last_grant` (the only age reset).
    """
    idx = owner_idx.reshape(-1).to(torch.int64)
    dev = idx.device

    def flag(x):
        return torch.as_tensor(x, dtype=torch.bool, device=dev).reshape(-1).expand(idx.shape)

    is_retry, apply, timed, active = flag(is_retry), flag(apply), flag(timed), flag(active)
    cd = ss.cooldown.index_select(0, idx)
    bo = ss.backoff.index_select(0, idx)
    rl = ss.retry_left.index_select(0, idx)
    lg = ss.last_grant.index_select(0, idx)
    sched = timed & (rl > 0)
    one = torch.ones_like(bo)
    new_cd = torch.where(sched, torch.bitwise_left_shift(one, torch.clamp(
        bo, max=policy.backoff_cap)), torch.where(is_retry, cd - 1, cd))
    new_bo = torch.where(sched, bo + 1, torch.where(apply, torch.zeros_like(bo), bo))
    new_rl = torch.where(sched, rl - 1, torch.where(
        apply, torch.full_like(rl, policy.max_retries), rl))
    t = torch.as_tensor(t, device=dev).to(torch.int32).reshape(-1).expand(idx.shape)
    new_lg = torch.where(apply, t, lg)
    for col, new, old in ((ss.last_grant, new_lg, lg), (ss.cooldown, new_cd, cd),
                          (ss.backoff, new_bo, bo), (ss.retry_left, new_rl, rl)):
        col.index_copy_(0, idx, torch.where(active, new, old))
    ss.clock.add_(ticks)
    return ss


def as_tick_times(times, k: Optional[int] = None, device=None) -> torch.Tensor:
    """Validate and coerce per-round arrival instants to a (K,) f32 tensor
    on `device` (the times' own device for a tensor, else CUDA when None).
    Checked on the host: 1-D, K long when `k` is given, finite and
    non-decreasing (the gaps become deadlines)."""
    if isinstance(times, torch.Tensor):
        dev = times.device if device is None else resolve_device(device)
        host = times.detach().cpu().numpy().astype(np.float32)
    else:
        dev = resolve_device(device)
        host = np.asarray(times, np.float32)
    if host.ndim != 1:
        raise ValueError(f"tick times must be 1-D, got shape {host.shape}")
    if k is not None and host.shape[0] != k:
        raise ValueError(f"{host.shape[0]} tick times for a {k}-round dispatch")
    if host.size and not np.isfinite(host).all():
        raise ValueError("tick times must be finite")
    if host.size > 1 and (np.diff(host) < 0).any():
        raise ValueError("tick times must be non-decreasing")
    return torch.from_numpy(host.copy()).to(dev)


__all__ = [
    "STALE_SALT", "LatencyPlan", "StalenessPolicy", "StalenessState",
    "init_staleness_state", "deadline_guard", "merge_timeout_codes",
    "staleness_weight", "staleness_tick", "as_tick_times",
]
