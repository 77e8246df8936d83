"""Checkpoints of the port's states: npz shards plus a msgpack manifest.

Counterpart of ``repro/checkpoint/store.py``, in the same format, so a
checkpoint written by either package loads into the other:

    <dir>/step_%08d/arrays.npz        one array per state leaf
    <dir>/step_%08d/manifest.msgpack  {"step", "keys", "dtypes", "shapes",
                                       ["aux_keys", "aux_dtypes"], ["extra"]}

Leaves are keyed as ``jax.tree_util.tree_flatten_with_path`` keys the
reference's states, with "/" between the parts and "__SL__" in the npz:
dict keys (sorted), NamedTuple field names (None fields left out), list
indices, and positional indices for the state classes the reference
registers as pytrees (`ParamFlat` buf; `QuantBank` codes, scales, residual;
`PagedBank` hot, hot_ids; `DeviceLedger` its eight columns; `TreeNoise`
nodes, counts). So a flat f32 state gives ``theta_L/0``, ``bank``,
``step``, ``ledger/0`` ... ``ledger/7``, and a paged int8 state
``bank/0/0`` (codes), ``bank/0/1`` (scales), ``bank/0/2`` (residual) and
``bank/1`` (the page table). Static fields (the spec, the codec, N, the
depth, the ledger's snapshot id) are not saved: they come from `like` on
load.

Saves are atomic: the shard is written under ``_tmp_step_*`` and renamed
into ``step_*``; overwriting a step first renames the old shard to
``_old_step_*``. Neither temporary name starts with ``step_``, so
`latest_step` never resumes from a torn shard.

bfloat16 and float8 tensors are stored as their bits (a uint16 or uint8
array) and the manifest records the logical dtype as numpy names it
("bfloat16", "float8_e4m3fn", "float8_e5m2"); the loader views the bits
back. numpy cannot hold those dtypes without ml_dtypes, which the port
does not use, so `load_aux_arrays` returns CPU tensors.

The row stores (`MemoryRowStore`, `MemmapRowStore`) are the paged owner
bank's cold tier (``federation.paging``): one fixed-shape row per owner,
partial reads and writes, and a never-written row reads as the shared
default row, so an N-owner store costs the rows actually written, not
N rows. Rows are numpy arrays in their storage dtype (bf16 and fp8 as
uint16 / uint8 bits, with `dtype` naming the logical one).
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint._msgpack import packb, unpackb

# logical dtypes numpy cannot hold without ml_dtypes: torch dtype and the
# same-width unsigned storage
_EXTENDED = {"bfloat16": (torch.bfloat16, np.uint16),
             "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
             "float8_e5m2": (torch.float8_e5m2, np.uint8)}
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}

# npz namespace of the aux arrays: kept out of the leaf keyspace
_AUX_PREFIX = "__AUX__"


def _logical_name(dtype: torch.dtype) -> Optional[str]:
    for name, (tdt, _) in _EXTENDED.items():
        if tdt == dtype:
            return name
    return None


def to_storage(x) -> Tuple[np.ndarray, str]:
    """(a numpy array that np.savez round-trips, its logical dtype name)
    for a tensor (on any device) or an array: bf16 and fp8 as their bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        name = _logical_name(t.dtype)
        if name is not None:
            return t.view(torch.uint8 if t.element_size() == 1 else torch.uint16).numpy(), name
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(x)
    if a.dtype.kind in "biufc":
        return a, str(a.dtype)
    # a numpy extended dtype (ml_dtypes, where the caller has it): its bits
    return a.view(_UINT[a.dtype.itemsize]), str(a.dtype)


def from_storage(a: np.ndarray, logical: Optional[str] = None) -> torch.Tensor:
    """A CPU tensor with the bits of `a` in its logical dtype."""
    # (np.ascontiguousarray would make a 0-d array 1-d)
    t = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
    if logical in _EXTENDED and logical != str(a.dtype):
        t = t.view(_EXTENDED[logical][0])
    return t


# ----------------------------- leaf paths -----------------------------------

def _node_children(x):
    """[(name, child)] of one node of a state, or None for a leaf. The
    state classes go by position, as their reference pytree registrations
    flatten them; NamedTuples by field, dicts by sorted key."""
    from repro_torch.federation.deep import TreeNoise
    from repro_torch.federation.flatten import PagedBank, ParamFlat, QuantBank
    from repro_torch.federation.privacy import DeviceLedger
    if isinstance(x, ParamFlat):
        return [("0", x.buf)]
    if isinstance(x, QuantBank):
        return [("0", x.codes), ("1", x.scales), ("2", x.residual)]
    if isinstance(x, PagedBank):
        return [("0", x.hot), ("1", x.hot_ids)]
    if isinstance(x, DeviceLedger):
        return [(str(i), getattr(x, c)) for i, c in enumerate(DeviceLedger.COLUMNS)]
    if isinstance(x, TreeNoise):
        return [("0", x.nodes), ("1", x.counts)]
    if isinstance(x, dict):
        return [(str(k), x[k]) for k in sorted(x)]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return list(zip(x._fields, x))
    if isinstance(x, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(x)]
    return None


def _walk(x, prefix: str, out: Dict[str, Any]) -> None:
    if x is None:
        return
    kids = _node_children(x)
    if kids is None:
        out[prefix] = x
        return
    for name, child in kids:
        _walk(child, f"{prefix}/{name}" if prefix else name, out)


def flatten_with_paths(tree) -> Dict[str, Any]:
    """{key: leaf} of a state or tree, keyed as the reference's
    `_flatten_with_paths` keys the same state (see the module docstring),
    in its leaf order."""
    out: Dict[str, Any] = {}
    _walk(tree, "", out)
    return out


def _rebuild(like, prefix: str, leaves: Dict[str, torch.Tensor]):
    """`like` with each leaf replaced by leaves[its key]; the static fields
    of the state classes come from `like`."""
    from repro_torch.federation.deep import TreeNoise
    from repro_torch.federation.flatten import PagedBank, ParamFlat, QuantBank
    from repro_torch.federation.privacy import DeviceLedger
    if like is None:
        return None

    def sub(name, child):
        return _rebuild(child, f"{prefix}/{name}" if prefix else name, leaves)

    if isinstance(like, ParamFlat):
        return ParamFlat(sub("0", like.buf), like.spec)
    if isinstance(like, QuantBank):
        return QuantBank(sub("0", like.codes), sub("1", like.scales), sub("2", like.residual),
                         like.codec)
    if isinstance(like, PagedBank):
        return PagedBank(sub("0", like.hot), sub("1", like.hot_ids), like.n_owners)
    if isinstance(like, DeviceLedger):
        cols = {c: sub(str(i), getattr(like, c)) for i, c in enumerate(DeviceLedger.COLUMNS)}
        return DeviceLedger(**cols, sid=like.sid)
    if isinstance(like, TreeNoise):
        return TreeNoise(sub("0", like.nodes), sub("1", like.counts), like.depth)
    if isinstance(like, dict):
        return {k: sub(str(k), v) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(sub(f, v) for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(sub(str(i), v) for i, v in enumerate(like))
    return leaves[prefix]


# ----------------------------- checkpoints ----------------------------------

def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, state: Any, extra: Optional[Dict] = None,
                    aux_arrays: Optional[Dict[str, Any]] = None) -> str:
    """Atomically write `state` (tensors on any device) under
    <directory>/step_<k>; returns the shard's path.

    `extra` (a msgpack-serializable dict, e.g. a mechanism's journal) rides
    in the manifest and comes back as load_manifest()['extra'].
    `aux_arrays` (name -> tensor or array; not part of the state, e.g. a
    paged session's cold-tier rows) go into the same npz under a reserved
    prefix, so the atomic rename covers them, and come back through
    load_aux_arrays()."""
    final = _step_dir(directory, step)
    tmp = os.path.join(directory, f"_tmp_step_{step:08d}.{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {k: to_storage(v) for k, v in flatten_with_paths(state).items()}
    payload = {k.replace("/", "__SL__"): a for k, (a, _) in arrays.items()}
    aux = {k: to_storage(v) for k, v in (aux_arrays or {}).items()}
    payload.update({_AUX_PREFIX + k.replace("/", "__SL__"): a for k, (a, _) in aux.items()})
    np.savez(os.path.join(tmp, "arrays.npz"), **payload)
    manifest = {"step": int(step),
                "keys": list(arrays),
                "dtypes": {k: name for k, (_, name) in arrays.items()},
                "shapes": {k: list(a.shape) for k, (a, _) in arrays.items()}}
    if aux:
        manifest["aux_keys"] = list(aux)
        manifest["aux_dtypes"] = {k: name for k, (_, name) in aux.items()}
    if extra is not None:
        manifest["extra"] = extra
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
    if os.path.isdir(final):
        # demote the old shard out of the step_ namespace first: no moment
        # exists where `final` is half-written
        trash = os.path.join(directory, f"_old_step_{step:08d}.{os.getpid()}")
        if os.path.exists(trash):
            shutil.rmtree(trash)
        os.rename(final, trash)
        os.rename(tmp, final)
        shutil.rmtree(trash)
    else:
        os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest step_<k> under `directory` (None when there is none);
    _tmp_step_* / _old_step_* leftovers and foreign entries are ignored."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for n in os.listdir(directory):
        if not n.startswith("step_"):
            continue
        try:
            steps.append(int(n.split("_")[1]))
        except ValueError:
            continue
    return max(steps) if steps else None


def load_manifest(directory: str, step: int) -> Dict:
    with open(os.path.join(_step_dir(directory, step), "manifest.msgpack"), "rb") as f:
        return unpackb(f.read())


def load_aux_arrays(directory: str, step: int) -> Dict[str, torch.Tensor]:
    """The aux arrays a save_checkpoint(aux_arrays=...) stored, as CPU
    tensors in their logical dtypes ({} for a checkpoint without any)."""
    manifest = load_manifest(directory, step)
    data = np.load(os.path.join(_step_dir(directory, step), "arrays.npz"))
    dtypes = manifest.get("aux_dtypes") or {}
    return {k: from_storage(data[_AUX_PREFIX + k.replace("/", "__SL__")], dtypes.get(k))
            for k in manifest.get("aux_keys") or []}


def load_checkpoint(directory: str, step: int, like: Any) -> Any:
    """Restore into the structure of `like`: every leaf checked against the
    checkpoint's shape and cast to `like`'s dtype on `like`'s device."""
    manifest = load_manifest(directory, step)
    data = np.load(os.path.join(_step_dir(directory, step), "arrays.npz"))
    stored = {k.replace("__SL__", "/") for k in data.files if not k.startswith(_AUX_PREFIX)}
    leaves = {}
    for key, leaf in flatten_with_paths(like).items():
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key.replace("/", "__SL__")]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(leaf.shape)}")
        t = from_storage(arr, manifest["dtypes"].get(key))
        leaves[key] = t.to(device=leaf.device, dtype=leaf.dtype)
    return _rebuild(like, "", leaves)


# --------------------------- cold-tier row stores ---------------------------

def _storage_dtype(dtype) -> Tuple[str, np.dtype]:
    """(logical name, numpy storage dtype) of a row store's `dtype`: a numpy
    dtype, or a logical name numpy has no dtype for ("bfloat16", ...)."""
    if isinstance(dtype, str) and dtype in _EXTENDED:
        return dtype, np.dtype(_EXTENDED[dtype][1])
    d = np.dtype(dtype)
    if d.kind in "biufc":
        return str(d), d
    return str(d), np.dtype(_UINT[d.itemsize])


class _RowStore:
    """What both row stores share: shape, dtype, default row, bounds."""

    def __init__(self, n_rows: int, row_shape, dtype, default):
        self.n_rows = int(n_rows)
        self.row_shape = tuple(row_shape)
        self.dtype, self.storage_dtype = _storage_dtype(dtype)
        default = np.array(self._as_storage(default), copy=True)   # never a view of the bank
        if tuple(default.shape) != self.row_shape:
            raise ValueError(f"default row shape {default.shape} != {self.row_shape}")
        default.setflags(write=False)
        self._default = default

    def __len__(self) -> int:
        return self.n_rows

    def _as_storage(self, values) -> np.ndarray:
        """Rows (a tensor or an array) as an array of the storage dtype,
        bits unchanged."""
        a = to_storage(values)[0] if isinstance(values, torch.Tensor) else np.asarray(values)
        if a.dtype != self.storage_dtype:
            if a.dtype.itemsize != self.storage_dtype.itemsize or a.dtype.kind in "fc":
                raise TypeError(f"rows of dtype {a.dtype} for a {self.dtype} store")
            a = a.view(self.storage_dtype)
        return a

    def _ids(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_rows):
            raise IndexError(f"row ids out of range for {self.n_rows}-row store")
        return ids

    def _values(self, ids: np.ndarray, values) -> np.ndarray:
        values = self._as_storage(values)
        if values.shape != (ids.size,) + self.row_shape:
            raise ValueError(f"values shape {values.shape} != {(ids.size,) + self.row_shape}")
        return values

    def _out(self, ids: np.ndarray, out) -> np.ndarray:
        if out is None:
            return np.empty((ids.size,) + self.row_shape, self.storage_dtype)
        if out.shape != (ids.size,) + self.row_shape or out.dtype != self.storage_dtype:
            raise ValueError(f"out {out.shape} {out.dtype} for {ids.size} rows of "
                             f"{self.row_shape} {self.storage_dtype}")
        return out


class MemoryRowStore(_RowStore):
    """Dict-backed row store: rows live on the host as numpy copies."""

    def __init__(self, n_rows: int, row_shape, dtype, default):
        super().__init__(n_rows, row_shape, dtype, default)
        self._rows: Dict[int, np.ndarray] = {}

    @property
    def written(self) -> int:
        """Rows that hold real (non-default) data."""
        return len(self._rows)

    @property
    def written_ids(self) -> np.ndarray:
        """Sorted (written,) int64 ids of the rows holding real data: what a
        checkpoint must keep (the others are the default row)."""
        return np.asarray(sorted(self._rows), np.int64)

    def clear(self) -> None:
        """Forget every written row (all read as the default again)."""
        self._rows.clear()

    def read_rows(self, ids, out: Optional[np.ndarray] = None) -> np.ndarray:
        """(k, *row_shape) rows in the storage dtype, into `out` when given
        (e.g. a view of pinned memory); never-written ids read as default."""
        ids = self._ids(ids)
        out = self._out(ids, out)
        for j, i in enumerate(ids):
            out[j] = self._rows.get(int(i), self._default)
        return out

    def write_rows(self, ids, values) -> None:
        ids = self._ids(ids)
        values = self._values(ids, values)
        for j, i in enumerate(ids):
            row = self._rows.get(int(i))
            if row is None:
                self._rows[int(i)] = np.copy(values[j])
            else:
                row[...] = values[j]          # a rewritten row reuses its memory


class MemmapRowStore(_RowStore):
    """Disk-backed row store on ``np.lib.format.open_memmap``.

    The (n_rows, *row_shape) .npy (`path`/rows.npy) is created at the first
    write, as a sparse file beside an in-memory written-row bitmap; never-
    written rows read as the default row, so a million-row store costs no
    disk until rows are evicted to it."""

    def __init__(self, path: str, n_rows: int, row_shape, dtype, default):
        super().__init__(n_rows, row_shape, dtype, default)
        self._dir = path
        self._data_path = os.path.join(path, "rows.npy")
        self._mm = None
        self._written = np.zeros((self.n_rows,), bool)

    def _map(self):
        if self._mm is None:
            os.makedirs(self._dir, exist_ok=True)
            self._mm = np.lib.format.open_memmap(self._data_path, mode="w+",
                                                 dtype=self.storage_dtype,
                                                 shape=(self.n_rows,) + self.row_shape)
        return self._mm

    @property
    def written(self) -> int:
        return int(self._written.sum())

    @property
    def written_ids(self) -> np.ndarray:
        return np.flatnonzero(self._written).astype(np.int64)

    def clear(self) -> None:
        """Forget every written row; the file's pages stay allocated but are
        no longer read."""
        self._written[:] = False

    def read_rows(self, ids, out: Optional[np.ndarray] = None) -> np.ndarray:
        ids = self._ids(ids)
        out = self._out(ids, out)
        for j, i in enumerate(ids):
            out[j] = self._mm[i] if self._written[i] else self._default
        return out

    def write_rows(self, ids, values) -> None:
        ids = self._ids(ids)
        values = self._values(ids, values)
        self._map()[ids] = values
        self._written[ids] = True

    def flush(self) -> None:
        if self._mm is not None:
            self._mm.flush()


__all__ = ["MemmapRowStore", "MemoryRowStore", "flatten_with_paths", "from_storage",
           "latest_step", "load_aux_arrays", "load_checkpoint", "load_manifest",
           "save_checkpoint", "to_storage"]
