"""Pluggable owner schedules: who communicates at tick k.

Counterpart of ``repro/federation/schedules.py``. A schedule turns a key
into the (T,) owner sequence the engines run over, on the key's device and
without a copy to the host. A (..., 2) batch of keys (``random``'s batched
form, the replicas of ``Federation.run(n_runs=...)``) gives (..., T)
sequences, each what its key gives alone; a key gives the reference's
owner sequence exactly.

  UniformSchedule           — line 3 of Algorithm 1: i.i.d. uniform draws
                              (the distributional shortcut for symmetric
                              rate-1 Poisson clocks).
  PoissonSchedule           — the continuous-time simulation itself, for
                              communication-timing studies (Figs. 3/9).
  AvailabilityTraceSchedule — beyond the paper: owners that only answer
                              inside per-owner availability windows of a
                              recurring period. Ticks still arrive from
                              superposed Poisson clocks; the mark is drawn
                              uniformly among the owners whose window holds
                              that instant (a Gumbel argmax), or replayed
                              from a recorded trace.

`as_owner_seq` normalizes hand-rolled sequences. `partition_conflict_free`,
`pack_groups` and `auto_max_group` are the host-side analysis behind
`Federation.run_rounds(..., owner_parallel=True)`: numpy logic, equal to
the reference's output exactly. `TraceRing` streams a recorded trace to
the device a chunk at a time, for the paged owner bank
(`federation.paging`): its host `window(k)` is what the pager prefetches.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch import random
from repro_torch.device import resolve_device
from repro_torch.federation.clocks import Schedule, poisson_schedule, uniform_schedule


@runtime_checkable
class ScheduleProtocol(Protocol):
    def draw(self, key: torch.Tensor, n_owners: int, horizon: int) -> torch.Tensor:
        """(T,) int32 owner sequence on the key's device ((..., T) for a
        (..., 2) batch of keys), with no copy to the host."""
        ...


def as_owner_seq(seq, n_owners: int, device=None) -> torch.Tensor:
    """Normalize an owner sequence to the engines' (K,) int32 form on
    `device` (CUDA when None), validating its bounds once (one host copy
    of the sequence)."""
    seq = seq if isinstance(seq, torch.Tensor) else torch.tensor(np.asarray(seq))
    if seq.ndim != 1:
        raise ValueError(f"owner sequence must be 1-D, got {tuple(seq.shape)}")
    if seq.dtype.is_floating_point or seq.dtype == torch.bool:
        raise ValueError(f"owner sequence must be integer, got {seq.dtype}")
    if seq.numel():
        lo, hi = (int(v) for v in torch.aminmax(seq.cpu()))
        if lo < 0 or hi >= n_owners:
            raise ValueError(f"owner sequence out of range for {n_owners} owners")
    return seq.to(device=resolve_device(device), dtype=torch.int32)


# ------------------ schedule analysis: conflict-free groups ----------------
# Rounds touching DISTINCT owners interact only through theta_L (each reads
# and writes its own bank row), so a run of consecutive rounds with no
# repeated owner can execute as one owner-parallel group.

def partition_conflict_free(owner_seq, max_group: Optional[int] = None
                            ) -> List[Tuple[int, int]]:
    """Greedy maximal partition of a host (K,) owner sequence into
    consecutive (start, length) groups of distinct owners.

    Greedy left to right gives the fewest groups: a group ends exactly when
    the next owner would repeat. `max_group` caps the length (1 is the
    sequential schedule). Run once per dispatch on the host."""
    seq = np.asarray(owner_seq)
    if seq.ndim != 1:
        raise ValueError(f"owner sequence must be 1-D, got {seq.shape}")
    if max_group is not None and max_group < 1:
        raise ValueError(f"max_group must be >= 1, got {max_group}")
    groups: List[Tuple[int, int]] = []
    start, seen = 0, set()
    for k, o in enumerate(seq.tolist()):
        if o in seen or (max_group is not None and k - start >= max_group):
            groups.append((start, k - start))
            start, seen = k, {o}
        else:
            seen.add(o)
    if len(seq) > start:
        groups.append((start, len(seq) - start))
    return groups


def auto_max_group(owner_seq, step_overhead: float = 4.0, cap: int = 16) -> int:
    """The group cap of `max_group="auto"`, from the sequence's own repeats.

    Each cap c of the ladder (1, 2, 3, 4, 6, 8, 12, 16), up to the longest
    conflict-free run and `cap`, is scored by partitioning the sequence:
    n_groups(c) * (c + step_overhead), a fixed cost per group plus the
    member compute padded to c slots. Ties go to the smaller cap. Returns 1
    when grouping cannot win (a single-owner schedule, an empty one)."""
    seq = np.asarray(owner_seq)
    if seq.size == 0:
        return 1
    longest = max(length for _, length in partition_conflict_free(seq))
    best_c, best_cost = 1, float("inf")
    for c in (1, 2, 3, 4, 6, 8, 12, 16):
        if c > min(longest, cap):
            break
        cost = len(partition_conflict_free(seq, c)) * (c + step_overhead)
        if cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def pack_groups(groups: List[Tuple[int, int]]) -> Tuple[np.ndarray, np.ndarray]:
    """(start, length) groups -> (idx, valid), both (n_groups, G_max):
    idx[g, j] is the round index of member j of group g; padding repeats
    round 0 with valid False."""
    if not groups:
        return np.zeros((0, 1), np.int32), np.zeros((0, 1), bool)
    gmax = max(length for _, length in groups)
    idx = np.zeros((len(groups), gmax), np.int32)
    valid = np.zeros((len(groups), gmax), bool)
    for g, (start, length) in enumerate(groups):
        idx[g, :length] = np.arange(start, start + length)
        valid[g, :length] = True
    return idx, valid


@dataclasses.dataclass(frozen=True)
class UniformSchedule:
    def draw(self, key: torch.Tensor, n_owners: int, horizon: int) -> torch.Tensor:
        return uniform_schedule(key, n_owners, horizon)


@dataclasses.dataclass(frozen=True)
class PoissonSchedule:
    rate: float = 1.0

    def draw_with_times(self, key: torch.Tensor, n_owners: int, horizon: int) -> Schedule:
        return poisson_schedule(key, n_owners, horizon, self.rate)

    def draw(self, key: torch.Tensor, n_owners: int, horizon: int) -> torch.Tensor:
        return self.draw_with_times(key, n_owners, horizon).owners


@dataclasses.dataclass(frozen=True)
class AvailabilityTraceSchedule:
    """Per-owner availability windows over a recurring period.

    windows[i] = (start, end) as fractions of `period` in [0, 1);
    wrap-around windows (start > end) model an owner whose hours straddle
    the period boundary. If no owner is available at a tick (a gap in the
    trace), every owner is considered available so the clock keeps ticking.

    `trace` replays a RECORDED owner sequence instead of sampling one
    (tiled to the horizon if shorter). The ids are validated against the
    windowed owner count at construction: an out-of-range id would
    otherwise gather past the bank inside the engines."""
    windows: Tuple[Tuple[float, float], ...]
    period: float = 24.0
    rate: float = 1.0
    trace: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.trace is None:
            return
        trace = tuple(int(o) for o in self.trace)
        if not trace:
            raise ValueError("an empty trace cannot schedule any round")
        n = len(self.windows)
        bad = sorted({o for o in trace if not 0 <= o < n})
        if bad:
            raise ValueError(
                f"trace owner ids {bad} out of range for the {n} windowed owners — "
                "inside the engines an out-of-range id would gather past the bank")
        object.__setattr__(self, "trace", trace)

    def _tiled(self, horizon: int, device: torch.device) -> torch.Tensor:
        """The recorded trace tiled to `horizon` as an int32 tensor on
        `device`, cached on the instance by (horizon, device): one upload
        per distinct horizon instead of one per draw. `_tiled_cache` is not
        a field, so equality, hash and replace are untouched."""
        cache = self.__dict__.get("_tiled_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_tiled_cache", cache)
        out = cache.get((horizon, device))
        if out is None:
            out = torch.from_numpy(np.resize(np.asarray(self.trace, np.int32),
                                             horizon)).to(device)
            cache[(horizon, device)] = out
        return out

    def draw_with_times(self, key: torch.Tensor, n_owners: int, horizon: int) -> Schedule:
        if len(self.windows) != n_owners:
            raise ValueError(f"{len(self.windows)} windows for {n_owners} owners")
        ks = random.split(key)
        k_time, k_pick = ks[..., 0, :], ks[..., 1, :]
        times = poisson_schedule(k_time, n_owners, horizon, self.rate).times
        if self.trace is not None:
            tiled = self._tiled(horizon, key.device)
            return Schedule(times, tiled.expand(times.shape))
        inside = self.available(times, fallback=True)                  # (..., T, N)
        gumbel = random.gumbel(k_pick, (horizon, n_owners))
        owners = torch.argmax(torch.where(inside, gumbel, -torch.inf), dim=-1)
        return Schedule(times, owners.to(torch.int32))

    def draw(self, key: torch.Tensor, n_owners: int, horizon: int) -> torch.Tensor:
        return self.draw_with_times(key, n_owners, horizon).owners

    def trace_ring(self, chunk: int = 4096, device=None) -> "TraceRing":
        """The recorded trace as a `TraceRing` (device buffer of `chunk`
        ids on `device`, CUDA when None): what a paged session streams
        instead of the tiled (K,) sequence `draw` makes."""
        if self.trace is None:
            raise ValueError("trace_ring needs a recorded trace (trace=...)")
        return TraceRing(self.trace, chunk=chunk, device=device)

    def available(self, times: torch.Tensor, fallback: bool = False) -> torch.Tensor:
        """(..., T, N) availability mask at the given (..., T) instants.

        fallback=True applies the everyone-available escape hatch at trace
        gaps that draw_with_times uses, so the mask matches what the draw
        sampled from; fallback=False is the raw window membership."""
        dev = times.device
        period = torch.full((), self.period, dtype=torch.float32, device=dev)
        phase = torch.remainder(times / period, 1.0).unsqueeze(-1)
        starts = torch.tensor([w[0] for w in self.windows], dtype=torch.float32, device=dev)
        ends = torch.tensor([w[1] for w in self.windows], dtype=torch.float32, device=dev)
        inside = torch.where(starts <= ends, (phase >= starts) & (phase < ends),
                             (phase >= starts) | (phase < ends))
        if fallback:
            inside = inside | ~inside.any(dim=-1, keepdim=True)
        return inside


class TraceRing:
    """A device ring buffer over a recorded owner trace.

    A production trace can hold tens of millions of rounds; tiling it to a
    dispatch's (K,) sequence on the device (what
    `AvailabilityTraceSchedule.draw` does) costs memory and upload time in
    the trace's length. The ring keeps the trace on the host and ONE
    `chunk`-long int32 buffer on the device:

      * ``next(k)`` returns the next k ids as a (k,) int32 view of that
        buffer and advances the cursor, uploading a new chunk only when the
        cursor crosses the chunk's end (one host-to-device copy per `chunk`
        rounds);
      * ``window(k)`` is the host peek the paging prefetcher keys on: the
        next k ids, with no advance and no device read.

    It wraps as ``np.resize`` tiles (the trace repeats end to end), so a
    session streaming through the ring runs the sequence `draw` would."""

    def __init__(self, trace, chunk: int = 4096, device=None):
        trace = np.asarray(trace, np.int32).reshape(-1)
        if trace.size == 0:
            raise ValueError("an empty trace cannot schedule any round")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self._trace = trace
        self.chunk = int(chunk)
        self.device = resolve_device(device)
        self.cursor = 0                 # absolute position in the tiling
        self._chunk_start = 0           # absolute start of the resident chunk
        self._buf: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return int(self._trace.size)

    @property
    def resident_bytes(self) -> int:
        """Device bytes the ring holds: O(chunk), whatever the trace's
        length."""
        return 0 if self._buf is None else self._buf.numel() * self._buf.element_size()

    def window(self, k: int) -> np.ndarray:
        """(k,) int32 host view of the next k owner ids (no advance)."""
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
        return np.take(self._trace, self.cursor + np.arange(k), mode="wrap")

    def _refill(self, start: int) -> None:
        idx = (start + np.arange(self.chunk)) % self._trace.size
        self._buf = torch.from_numpy(self._trace[idx]).to(self.device)
        self._chunk_start = start

    def next(self, k: int) -> torch.Tensor:
        """The next k owner ids as a (k,) int32 device tensor; advances the
        cursor. k above the chunk uploads exactly those k ids (correct, not
        buffered): size the chunk at or above the dispatch length."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if k > self.chunk:
            out = torch.from_numpy(self.window(k)).to(self.device)
            self.cursor += k
            return out
        if self._buf is None or self.cursor + k > self._chunk_start + self.chunk:
            self._refill(self.cursor)
        off = self.cursor - self._chunk_start
        self.cursor += k
        return self._buf[off:off + k]
