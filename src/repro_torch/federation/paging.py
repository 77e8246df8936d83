"""The paged owner bank: the host pager and the paged state.

Counterpart of ``repro/federation/paging.py``. The flat engine's owner bank
is its largest cost, N copies of the model on the device: at DENSE_124M a
row is 611 MB of f32, so an 80 GB card holds about a hundred owners. A
dispatch only touches the owners its schedule window names, so the bank
is split into two tiers:

  * HOT, on the device: `n_hot` rows (``flatten.PagedBank``: a dense
    (n_hot, P) matrix or a QuantBank of n_hot code rows, and the sorted
    (n_hot,) int32 page table). The DP-FTRL tree's node rows page WITH
    their bank rows ((n_hot, d, P)); every (N,) column (the ledger, the
    tree's leaf counts, the fault and runtime counters) stays resident, so
    paging moves rows, never the accounting.
  * COLD, on the host: a row store per buffer (``checkpoint.MemoryRowStore``,
    or ``MemmapRowStore`` on disk) in which a never-written owner reads as
    the shared initial row, so an N-owner federation costs the rows
    actually trained, not N * P.

`OwnerPager` is the host half. Before each dispatch the session hands it
the window the dispatch will run (`prefetch`): owners already resident
cost nothing; the others load from the cold tier into slots freed by
evicting the least recently dispatched rows (dirty rows are written back
first, clean ones just drop). A prefetch re-lays the hot tier in place
(the state is consumed, as the drivers consume it) with one gather and one
scatter per device buffer, and uploads the page table once; the copies between the
tiers go through pinned host memory on CUDA, and a hot row is read back
only between dispatches, never inside one. Inside the drivers a row's
slot comes from ``PagedBank.lookup`` on the device, and an owner that is
not resident is a bit-exact masked no-op counted as a refusal.

On a device mesh (`init_paged_state(..., mesh=)`,
`sharding.rules.paged_shardings`) the hot rows shard like bank rows with
n_hot for N: each rank's hot tier is its block of slots and columns, the
page table is replicated, and every rank's pager keeps the cold rows of
its own columns. The pagers take the same decisions from the replicated
schedule; a row that changes slot, or is written back, is gathered over
the row group (the slot's holder has it), and each rank installs the rows
of the slots it holds.

Bit-exactness: rows round-trip the cold tier bit for bit for every
storage (f32, bf16, f16, the int8/fp8 codes and scales), the int8/fp8 error-
feedback residual belongs to the session and never pages, and with
n_hot >= N every row stays resident: the paged engine then equals the
flat one bit for bit on all three drivers.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.checkpoint import MemmapRowStore, MemoryRowStore
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.checkpoint.store import to_storage
from repro_torch.device import resolve_device
from repro_torch.federation.deep import (AsyncDPConfig, AsyncDPState, TreeNoise, _armed,
                                         _take_rows)
from repro_torch.federation.flatten import (PagedBank, QuantBank, flatten_spec, init_flat_bank,
                                            pack_params)
from repro_torch.federation.privacy import make_device_ledger
from repro_torch.sharding.flat import FlatLayout
from repro_torch.sharding.rules import paged_shardings


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class OwnerPager:
    """The host half of the paged owner bank (see the module docstring).

    It keeps a host mirror of the device page table, the dirty set (owners
    dispatched since their row was last written back: a dispatch may
    rewrite any row it touches, so a prefetch marks its window dirty) and
    a last-dispatch stamp per resident owner for the LRU order.

    `stats` counts prefetches, loads (rows read from the cold tier),
    evictions and writebacks (rows written to it), as the reference's.
    `io` adds the bytes and the seconds of the moves each way, end to end:
    d2h for the rows written back (evictions and flushes: the gather, the
    copy to pinned memory and the store's write), h2d for the rows loaded
    and the page table (the store's read into pinned memory, the copy up,
    the scatter; the device synchronized at the end). Both are read in
    place through `telemetry.counters()`."""

    def __init__(self, n_owners: int, n_hot: int, hot_ids: np.ndarray,
                 stores: Dict[str, Any], layout=None):
        self.n_owners = int(n_owners)
        self.n_hot = int(n_hot)
        self.layout = layout                             # a FlatLayout on a mesh
        self._sentinel = self.n_owners
        self._hot_ids = np.array(hot_ids, np.int32)      # host mirror, sorted
        self.stores = stores                             # buffer name -> row store
        self.dirty: set = set()
        self._clock = 0
        self._last_used: Dict[int, int] = {
            int(o): 0 for o in self._hot_ids if o != self._sentinel}
        self.stats = {"prefetches": 0, "loads": 0, "evictions": 0, "writebacks": 0}
        self.io = {"d2h_bytes": 0, "d2h_s": 0.0, "h2d_bytes": 0, "h2d_s": 0.0}
        telemetry.register_pager(self)

    @property
    def resident_ids(self) -> np.ndarray:
        """Sorted real owner ids resident now (the host mirror)."""
        return self._hot_ids[self._hot_ids != self._sentinel]

    def _slot_of(self) -> Dict[int, int]:
        return {int(o): s for s, o in enumerate(self._hot_ids) if o != self._sentinel}

    @staticmethod
    def _buffers(state: AsyncDPState, names) -> Dict[str, torch.Tensor]:
        """The device tensor each store pages: hot rows, codes and scales,
        tree nodes."""
        hot = state.bank.hot
        out = {}
        for name in names:
            if name == "rows":
                out[name] = hot
            elif name in ("codes", "scales"):
                out[name] = getattr(hot, name)
            else:
                out[name] = state.tree.nodes
        return out

    def _write_back(self, state: AsyncDPState, ids: List[int], slots: List[int]) -> None:
        """Write the rows of `slots` to the cold tier as owners `ids`: per
        buffer one gather, one device-to-host copy (into pinned memory on
        CUDA) and the store's write."""
        t0 = time.perf_counter()
        for name, buf in self._buffers(state, self.stores).items():
            rows = _take_rows(buf, torch.as_tensor(slots, dtype=torch.int64,
                                                   device=buf.device), self.layout)
            if rows.is_cuda:
                host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                host.copy_(rows)
            else:
                host = rows
            self.stores[name].write_rows(ids, to_storage(host)[0])
            self.io["d2h_bytes"] += rows.numel() * rows.element_size()
        self.stats["writebacks"] += len(ids)
        self.dirty.difference_update(ids)
        self.io["d2h_s"] += time.perf_counter() - t0

    def _install(self, state: AsyncDPState, new_ids: np.ndarray, src: np.ndarray,
                 fresh_pos: List[int], fresh_ids: List[int]) -> AsyncDPState:
        """Re-lay the hot tier IN PLACE: slot i takes old slot src[i], and the
        fresh rows (loaded from the cold tier, or its default row) land at
        fresh_pos. Per buffer: one gather of the surviving rows that change
        slot, one host-to-device copy of the fresh rows (from pinned memory
        on CUDA) and one scatter of both; then the page table is uploaded
        once."""
        t0 = time.perf_counter()
        fresh = set(fresh_pos)
        moved_pos = [p for p in range(self.n_hot) if p not in fresh and src[p] != p]
        bufs = self._buffers(state, self.stores)
        dev = next(iter(bufs.values())).device
        src_d = torch.as_tensor(src[moved_pos], dtype=torch.int64, device=dev)
        dst_d = torch.as_tensor(moved_pos + list(fresh_pos), dtype=torch.int64, device=dev)
        n_moved, copied = len(moved_pos), 0
        lay = self.layout
        if lay is not None:
            # this rank writes the destination slots it holds
            dst_all = moved_pos + list(fresh_pos)
            keep = [j for j, d in enumerate(dst_all) if lay.r0 <= d < lay.r0 + lay.n_local]
            keep_d = torch.as_tensor(keep, dtype=torch.int64, device=dev)
            dst_d = torch.as_tensor([dst_all[j] - lay.r0 for j in keep], dtype=torch.int64,
                                    device=dev)
        for name, buf in bufs.items():
            store = self.stores[name]
            stage = torch.empty((len(moved_pos) + len(fresh_pos),) + tuple(buf.shape[1:]),
                                dtype=buf.dtype, device=dev)
            if n_moved and lay is not None:
                stage[:n_moved] = _take_rows(buf, src_d, lay)
            elif n_moved:
                torch.index_select(buf, 0, src_d, out=stage[:n_moved])
            if fresh_ids:
                host = torch.empty((len(fresh_ids),) + tuple(buf.shape[1:]), dtype=buf.dtype,
                                   pin_memory=dev.type == "cuda")
                rows = to_storage(host)[0]          # a view of `host` in the storage dtype
                for j, o in enumerate(fresh_ids):
                    if o == self._sentinel:
                        rows[j] = store._default
                    else:
                        store.read_rows([o], out=rows[j:j + 1])
                stage[n_moved:].copy_(host, non_blocking=True)
                copied += host.numel() * host.element_size()
            if lay is not None:
                stage = stage.index_select(0, keep_d)
            buf.index_copy_(0, dst_d, stage)
            del stage
        state.bank.hot_ids.copy_(torch.from_numpy(np.asarray(new_ids, np.int32)))
        _sync(dev)
        self.io["h2d_bytes"] += copied + 4 * self.n_hot
        self.io["h2d_s"] += time.perf_counter() - t0
        self._hot_ids = np.array(new_ids, np.int32)
        return state

    def prefetch(self, state: AsyncDPState, window) -> AsyncDPState:
        """Make every owner of the coming dispatch's window resident.

        `window` is the HOST view of the owners the next dispatch runs (a
        `TraceRing.window(k)`, or the (K,) sequence about to be dispatched).
        Resident owners cost nothing; the others load from the cold tier
        into slots freed by evicting the least recently dispatched rows
        (dirty ones written back first). Raises when the window names more
        distinct owners than n_hot. Every owner of the window is marked
        dirty: the dispatch may rewrite any row it touches."""
        ids = np.unique(np.asarray(window, np.int64).reshape(-1))
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_owners):
            raise ValueError(f"window owner ids out of range for {self.n_owners} owners")
        if ids.size > self.n_hot:
            raise ValueError(
                f"dispatch window touches {ids.size} distinct owners but the hot tier "
                f"holds {self.n_hot} rows; raise n_hot or shorten the dispatch")
        self.stats["prefetches"] += 1
        self._clock += 1
        id_list = [int(i) for i in ids]
        for o in id_list:
            self._last_used[o] = self._clock
        resident = set(int(o) for o in self.resident_ids)
        need = [o for o in id_list if o not in resident]
        self.dirty.update(id_list)
        if not need:
            return state

        # victims: the least recently dispatched residents this window
        # does not need
        keep_free = resident - set(id_list)
        n_free = self.n_hot - len(resident)
        n_evict = max(0, len(need) - n_free)
        victims = sorted(keep_free, key=lambda o: (self._last_used.get(o, -1), o))[:n_evict]
        slot_of = self._slot_of()
        if victims:
            self._evict(state, victims, slot_of)

        new_res = sorted((resident - set(victims)) | set(need))
        new_ids = np.full((self.n_hot,), self._sentinel, np.int32)
        new_ids[:len(new_res)] = new_res          # the sentinel sorts last: sorted

        # survivors move from their old slot; loaded owners and empty slots
        # take fresh rows (the cold tier serves the default row for owners
        # never written, and an empty slot never keeps stale bits)
        src = np.zeros((self.n_hot,), np.int64)
        fresh_pos: List[int] = []
        fresh_ids: List[int] = []
        survivors = resident - set(victims)
        for pos, o in enumerate(new_ids.tolist()):
            if o != self._sentinel and o in survivors:
                src[pos] = slot_of[o]
            else:
                fresh_pos.append(pos)
                fresh_ids.append(o)
        self.stats["loads"] += sum(1 for o in fresh_ids if o != self._sentinel)
        return self._install(state, new_ids, src, fresh_pos, fresh_ids)

    def _evict(self, state: AsyncDPState, victims: List[int], slot_of: Dict[int, int]) -> None:
        """Write the dirty victims' rows back to the cold tier."""
        self.stats["evictions"] += len(victims)
        dirty_victims = [v for v in victims if v in self.dirty]
        if dirty_victims:
            self._write_back(state, dirty_victims, [slot_of[v] for v in dirty_victims])

    def flush(self, state: AsyncDPState, only_dirty: bool = True) -> None:
        """Write resident rows back to the cold tier WITHOUT evicting them
        (a checkpoint or a shutdown), a few rows at a time
        (`checkpoint.store.PIECE_BYTES`); `only_dirty=False` writes every
        resident row."""
        slot_of = self._slot_of()
        ids = [o for o in (int(i) for i in self.resident_ids)
               if not only_dirty or o in self.dirty]
        # a few rows at a time: the gathered copy stays within PIECE_BYTES
        row = max(b[0].numel() * b.element_size()
                  for b in self._buffers(state, self.stores).values())
        k = max(1, ckpt_store.PIECE_BYTES // max(1, row))
        for a in range(0, len(ids), k):
            self._write_back(state, ids[a:a + k], [slot_of[o] for o in ids[a:a + k]])

    def adopt(self, state: AsyncDPState) -> None:
        """Re-sync the host mirrors to a RESTORED state (crash-resume): the
        restored page table is authoritative, nothing is dirty (the
        checkpoint was saved through flush(only_dirty=False), so every
        resident row's bits are in the restored cold tier), and the LRU
        stamps restart."""
        self._hot_ids = state.bank.hot_ids.cpu().numpy().astype(np.int32)
        self.dirty = set()
        self._clock = 0
        self._last_used = {int(o): 0 for o in self._hot_ids if o != self._sentinel}

    def snapshot(self, state: AsyncDPState) -> Dict[str, np.ndarray]:
        """Every paged buffer as (N, ...) host rows in the stores' storage
        dtypes, after a full flush (tests and inspection: this is the O(N*P)
        cost paging exists to avoid)."""
        self.flush(state, only_dirty=False)
        all_ids = np.arange(self.n_owners, dtype=np.int64)
        return {key: store.read_rows(all_ids) for key, store in self.stores.items()}


def init_paged_state(params, cfg: AsyncDPConfig, n_hot: int, bank_dtype=None, device=None,
                     cold_dir: Optional[str] = None, mesh=None
                     ) -> Tuple[AsyncDPState, OwnerPager]:
    """A flat-engine state with a PAGED owner bank, and its host pager, on
    `device` (CUDA when None).

    As `deep.init_state_flat`, except that the (N, P) bank (and the tree's
    (N, d, P) nodes) become an (n_hot, ...) hot tier over a cold row store:
    device bytes are O(n_hot * P), whatever N is. `bank_dtype` picks the
    storage as for the flat bank (None/f32, torch.bfloat16, torch.float16,
    "int8"/"fp8").
    `cold_dir` puts the cold tier on disk (`MemmapRowStore`, created at the
    first eviction); None keeps it in host memory.

    At init every row, hot, cold or never written, is the default row (the
    packed params in the bank's storage), which is what lets the fault
    layer tile one checksum over the (N,) column.

    `mesh` lays the hot tier out on a device mesh
    (`sharding.rules.paged_shardings`: hot rows like bank rows with n_hot
    for N); each rank's cold tier keeps its columns. On disk, give each
    rank its own `cold_dir`."""
    n_hot = int(n_hot)
    if n_hot < 1:
        raise ValueError(f"n_hot must be >= 1, got {n_hot}")
    device = resolve_device(device)
    layout = None
    if mesh is not None:
        p = flatten_spec(params).size
        layout = FlatLayout(paged_shardings(mesh, n_hot, p), n_hot, p)
    flat = pack_params(params, device=device, layout=layout)
    N = cfg.n_owners
    hot = init_flat_bank(flat, n_hot, bank_dtype)
    m = min(n_hot, N)
    ids = np.full((n_hot,), N, np.int32)                # the sentinel N sorts last
    ids[:m] = np.arange(m, dtype=np.int32)
    bank = PagedBank(hot, torch.from_numpy(ids).to(device), N)
    tree = None
    if cfg.tree_depth is not None:
        tree = TreeNoise(torch.zeros((n_hot if layout is None else layout.n_local,
                                      cfg.tree_depth, flat.buf.shape[0]), dtype=torch.float32,
                                     device=device),
                         torch.zeros(N, dtype=torch.int32, device=device), cfg.tree_depth)
    # the fault checksums and the runtime counters are (N,) columns: they
    # stay resident
    faults, stale = _armed(cfg, bank, device, layout)

    def make_store(name, default: torch.Tensor):
        arr, logical = to_storage(default)
        if cold_dir is None:
            return MemoryRowStore(N, arr.shape, logical, arr)
        return MemmapRowStore(os.path.join(cold_dir, name), N, arr.shape, logical, arr)

    stores: Dict[str, Any] = {}
    if isinstance(hot, QuantBank):
        stores["codes"] = make_store("codes", hot.codes[0])
        stores["scales"] = make_store("scales", hot.scales[0])
    else:
        stores["rows"] = make_store("rows", hot[0])
    if tree is not None and cfg.tree_depth:
        stores["tree"] = make_store("tree", torch.zeros((cfg.tree_depth, flat.buf.shape[0]),
                                                        dtype=torch.float32))
    state = AsyncDPState(flat, bank, torch.zeros((), dtype=torch.int32, device=device),
                         make_device_ledger(cfg.effective_caps, device=device), tree, faults,
                         stale)
    return state, OwnerPager(N, n_hot, ids, stores, layout)


__all__ = ["OwnerPager", "init_paged_state"]
