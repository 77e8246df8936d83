"""Carry weights and bank state from the reference package into the port.

    np_params = jax.tree_util.tree_map(np.asarray, jax_params)   # caller side
    params = params_from_numpy(np_params)              # on CUDA; device="cpu" for the CPU
    cache = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jax_cache))  # decode caches
    bank = quant_bank_from_numpy(np.asarray(qb.codes), np.asarray(qb.scales),
                                 np.asarray(qb.residual), qb.codec.fmt)
    tree = tree_noise_from_numpy(np.asarray(tn.nodes), np.asarray(tn.counts), tn.depth)
    state = pytree_state_from_numpy(np_theta_L, np_bank, step, tree=tree)  # a pytree state
    state = pytree_state_from_numpy(np_theta_L, np_bank, step, tree=tree_noise_from_numpy(
        np_nodes, counts, depth, mesh=mesh, specs=specs), mesh=mesh, specs=specs)  # on a mesh
    spec = flat_spec_from_numpy(np_params)          # leaf shapes and dtypes, no storage
    state = flat_state_from_numpy(np_params, np.asarray(js.theta_L.buf),
                                  np.asarray(js.bank), int(js.step))  # a flat state
    faults = fault_state_from_numpy(*map(np.asarray, fs))          # a FaultState
    stale = staleness_state_from_numpy(*map(np.asarray, ss))       # a StalenessState
    ledger = device_ledger_from_numpy(spent, cap, refused, dropped=..., sid=led.sid)

The input is the reference's parameter tree with every array mapped to
numpy: nested dicts, lists/tuples and NamedTuples (read through their
``_asdict()``, so no jax import is needed here). NamedTuples become the
port's class of the same name (`AttnParams`, `MLPParams`, `Mamba2Params`,
`MoEParams`, `MLSTMParams`, `SLSTMParams`; in a cache also `KVCache`,
`Mamba2State`, `MLSTMState` and `SLSTMState`), None fields stay None, and
every array becomes a tensor with the same values, shape and dtype (a
bfloat16 array, numpy's ml_dtypes kind, is carried by its bits). A packed
flat state carries across with its spec, whose leaves may be f32, bf16 or
f16: the spec is taken from the reference's model tree (its shapes and
dtypes, on the meta device), the (P,) f32 buffer and the bank (dense rows
in f32, bf16 or f16, or a QuantBank) from the state's arrays.

A pytree state lands on a device mesh with `mesh=` and `specs=` (the
params' `sharding.rules.param_specs` tree): theta_L in the params'
placements, the bank and a pytree tree's nodes with their owner (and
level) axes replicated in front (`param_specs(..., bank_axis=True)`,
`(..., node_axes=True)`), each rank copying only its blocks of the arrays
to the device (`rules.distribute_blocks`); `step`, the ledger, the leaf
counts and the fault and runtime columns are replicated plain tensors, as
`deep.init_state(..., mesh=)` builds them.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.federation.deep import AsyncDPState, TreeNoise
from repro_torch.federation.faults import FaultState
from repro_torch.federation.flatten import BankCodec, FlatSpec, ParamFlat, QuantBank, flatten_spec
from repro_torch.federation.privacy import DeviceLedger
from repro_torch.federation.staleness import StalenessState
from repro_torch.models.attention import AttnParams, KVCache
from repro_torch.models.mlp import MLPParams
from repro_torch.models.moe import MoEParams
from repro_torch.models.ssm import Mamba2Params, Mamba2State
from repro_torch.models.xlstm import MLSTMParams, MLSTMState, SLSTMParams, SLSTMState
from repro_torch.tree_util import tree_flatten

_PARAMS = {cls.__name__: cls for cls in (AttnParams, MLPParams, Mamba2Params, MoEParams,
                                         MLSTMParams, SLSTMParams)}
_CACHES = {cls.__name__: cls for cls in (KVCache, Mamba2State, MLSTMState, SLSTMState)}


def params_from_numpy(tree: Any, device=None) -> Any:
    """The port's params on `device` (CUDA when None)."""
    return _convert(tree, resolve_device(device))


def cache_from_numpy(tree: Any, device=None) -> Any:
    """The port's decode cache on `device` (CUDA when None) from a
    reference cache (`LM.init_cache`'s dict of `KVCache`s and lists of
    `Mamba2State`s, `MLSTMState`s and `SLSTMState`s), so that a decode can
    go on from the reference's state."""
    return _convert(tree, resolve_device(device), _CACHES)


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _meta(a, device=None) -> torch.Tensor:
    """A meta tensor with the shape and dtype of array `a` (no storage)."""
    a = np.asarray(a)
    dtype = (torch.bfloat16 if a.dtype.name == "bfloat16"
             else torch.from_numpy(np.zeros((), a.dtype)).dtype)
    return torch.empty(tuple(a.shape), dtype=dtype, device="meta")


def _convert(tree: Any, device: torch.device, classes=None, leaf=_tensor) -> Any:
    classes = _PARAMS if classes is None else classes
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device, classes, leaf) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        name = type(tree).__name__
        if name not in classes:
            raise TypeError(f"no port counterpart for NamedTuple {name!r} here")
        return classes[name](**{k: _convert(v, device, classes, leaf)
                                for k, v in tree._asdict().items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device, classes, leaf) for v in tree)
    return leaf(tree, device)


def flat_spec_from_numpy(tree: Any) -> FlatSpec:
    """The port's FlatSpec of a reference model tree mapped to numpy: the
    leaves' shapes and dtypes (f32, bf16 or f16; another dtype raises
    TypeError) in jax's order, read without copying any array."""
    return flatten_spec(_convert(tree, torch.device("meta"), leaf=_meta))


def flat_state_from_numpy(params: Any, buf: np.ndarray, bank, step: int = 0,
                          tree: Optional[TreeNoise] = None,
                          ledger: Optional[DeviceLedger] = None,
                          faults: Optional[FaultState] = None,
                          stale: Optional[StalenessState] = None,
                          device=None) -> AsyncDPState:
    """A port flat state on `device` (CUDA when None) from a reference flat
    state's arrays: `params` the model tree mapped to numpy (or a FlatSpec)
    for the spec, `buf` the (P,) f32 packed theta_L, `bank` the (N, P) dense
    bank (f32, bf16 or f16 rows) or a port QuantBank
    (`quant_bank_from_numpy`), the granted-round count `step`, and the tree,
    ledger, fault and runtime states as for `pytree_state_from_numpy`."""
    device = resolve_device(device)
    spec = params if isinstance(params, FlatSpec) else flat_spec_from_numpy(params)
    buf = np.asarray(buf)
    if buf.dtype != np.float32 or buf.shape != (spec.size,):
        raise ValueError(f"a packed buffer is ({spec.size},) float32, got {buf.shape} "
                         f"{buf.dtype}")
    if not isinstance(bank, QuantBank):
        bank = _tensor(bank, device)
        if bank.dim() != 2 or bank.shape[1] != spec.size:
            raise ValueError(f"a bank of shape {tuple(bank.shape)} does not hold rows of "
                             f"({spec.size},)")
    return AsyncDPState(ParamFlat(_tensor(buf, device), spec), bank,
                        torch.tensor(int(step), dtype=torch.int32, device=device),
                        ledger, tree, faults, stale)


def quant_bank_from_numpy(codes: np.ndarray, scales: np.ndarray, residual: np.ndarray,
                          fmt: str, block_elems: Optional[int] = None,
                          device=None) -> QuantBank:
    """A port QuantBank on `device` (CUDA when None) from a reference
    QuantBank's arrays: (N, P) codes (int8, or fp8 as raw uint8 bit
    patterns; a float8 array is read as its bytes), (N, nb) f32 scales and
    the (P,) f32 residual."""
    codec = BankCodec(fmt, block_elems)
    device = resolve_device(device)

    def tensor(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)

    # the codes' bytes, whatever 1-byte dtype carries them
    codes = np.asarray(codes).view(np.int8 if fmt == "int8" else np.uint8)
    return QuantBank(tensor(codes, codes.dtype), tensor(scales, np.float32),
                     tensor(residual, np.float32), codec)


def _blocks(tree: Any, specs: Any, mesh, device: torch.device, lead: int) -> Any:
    """A reference tree of arrays as the port's tree of DTensors on `mesh`
    (module docstring), each rank building only its blocks."""
    from repro_torch.sharding import rules
    arrays = _convert(tree, device, leaf=lambda a, _device: np.asarray(a))
    return rules.distribute_blocks(arrays, specs, mesh, lead, lambda a: _tensor(a, device))


def tree_noise_from_numpy(nodes, counts: np.ndarray, depth: int, device=None, mesh=None,
                          specs=None) -> TreeNoise:
    """A port TreeNoise on `device` (CUDA when None) from a reference
    TreeNoise's arrays: the nodes, either one (N, depth, P) f32 array (a
    flat state's) or the model tree of (N, depth, *leaf.shape) arrays (a
    pytree state's), and the (N,) int32 leaf counts. A pytree state's
    nodes land on a device mesh with `mesh=` and `specs=` (the params'
    `param_specs`), each rank building only its (N, depth, *block)."""
    device = resolve_device(device)
    if mesh is not None and (specs is None or isinstance(nodes, np.ndarray)):
        raise ValueError("nodes on a mesh are a pytree state's, placed by the params' "
                         "specs (sharding.rules.param_specs)")
    counts = np.asarray(counts, dtype=np.int32)
    if isinstance(nodes, np.ndarray):
        nodes = np.asarray(nodes, dtype=np.float32)
        if nodes.ndim != 3 or nodes.shape[1] != depth or counts.shape != nodes.shape[:1]:
            raise ValueError(f"nodes {nodes.shape} and counts {counts.shape} are not a "
                             f"flat depth-{depth} tree")
        tensors = torch.from_numpy(nodes.copy()).to(device)
    else:
        tensors = (_convert(nodes, device) if mesh is None
                   else _blocks(nodes, specs, mesh, device, lead=2))
        for leaf in tree_flatten(tensors)[0]:
            if leaf.dim() < 2 or leaf.shape[1] != depth or leaf.shape[:1] != counts.shape:
                raise ValueError(f"a node leaf of shape {tuple(leaf.shape)} and counts "
                                 f"{counts.shape} are not a depth-{depth} tree")
            if leaf.dtype != torch.float32:
                raise TypeError(f"node leaves are f32, got {leaf.dtype}")
    return TreeNoise(tensors, torch.from_numpy(counts.copy()).to(device), int(depth))


def _int_column(a, dtype=np.int32) -> np.ndarray:
    return np.array(a, dtype=dtype, copy=True)


def fault_state_from_numpy(checksum, win_faults, contacts, quarantined,
                           device=None) -> FaultState:
    """A port FaultState on `device` (CUDA when None) from a reference
    FaultState's arrays: (N,) int32 checksums, window faults and contacts,
    and the (N,) bool quarantine flags."""
    device = resolve_device(device)
    cols = [_int_column(checksum), _int_column(win_faults), _int_column(contacts),
            _int_column(quarantined, bool)]
    if len({c.shape for c in cols}) != 1 or cols[0].ndim != 1:
        raise ValueError(f"fault columns of shapes {[c.shape for c in cols]} are not (N,)")
    return FaultState(*(torch.from_numpy(c).to(device) for c in cols))


def staleness_state_from_numpy(clock, last_grant, cooldown, backoff, retry_left,
                               device=None) -> StalenessState:
    """A port StalenessState on `device` (CUDA when None) from a reference
    StalenessState's arrays: the () int32 clock and the (N,) int32
    last-grant stamps, cooldowns, backoff exponents and retry budgets."""
    device = resolve_device(device)
    cols = [_int_column(c) for c in (last_grant, cooldown, backoff, retry_left)]
    if len({c.shape for c in cols}) != 1 or cols[0].ndim != 1:
        raise ValueError(f"runtime columns of shapes {[c.shape for c in cols]} are not (N,)")
    return StalenessState(torch.from_numpy(_int_column(clock).reshape(())).to(device),
                          *(torch.from_numpy(c).to(device) for c in cols))


def device_ledger_from_numpy(spent, cap, refused, dropped=None, faulted=None,
                             quarantined=None, timed_out=None, retried=None, sid: int = 0,
                             device=None) -> DeviceLedger:
    """A port DeviceLedger on `device` (CUDA when None) from a reference
    DeviceLedger's (N,) int32 columns (spent, cap, refused and the five
    fault and staleness columns; an absent one is zeros) and its snapshot
    id."""
    device = resolve_device(device)

    def col(a):
        return None if a is None else torch.from_numpy(_int_column(a)).to(device)

    return DeviceLedger(col(spent), col(cap), col(refused), dropped=col(dropped),
                        faulted=col(faulted), quarantined=col(quarantined),
                        timed_out=col(timed_out), retried=col(retried), sid=int(sid))


def pytree_state_from_numpy(theta_L: Any, bank: Any, step: int = 0,
                            tree: Optional[TreeNoise] = None,
                            ledger: Optional[DeviceLedger] = None,
                            faults: Optional[FaultState] = None,
                            stale: Optional[StalenessState] = None,
                            device=None, mesh=None, specs=None) -> AsyncDPState:
    """A port pytree state on `device` (CUDA when None) from a reference
    pytree state's arrays: theta_L the model tree, `bank` the same tree with
    (N, *leaf.shape) leaves, the granted-round count `step`, and the noise
    trees (`tree_noise_from_numpy`) under the tree mechanism, and the
    fault and runtime counters (`fault_state_from_numpy`,
    `staleness_state_from_numpy`) when the session arms them. The ledger is
    the session's to give (`Federation.init_state` seeds one from the live
    accountant; `device_ledger_from_numpy` carries a reference's); None
    leaves it out.

    On a device mesh (`mesh` and `specs`, the params' `param_specs` tree)
    theta_L and the bank are DTensors, each rank building only its blocks
    (module docstring); a tree's nodes come from
    `tree_noise_from_numpy(..., mesh=, specs=)`."""
    device = resolve_device(device)
    if mesh is not None and specs is None:
        raise ValueError("pytree_state_from_numpy(mesh=) needs the params' specs "
                         "(sharding.rules.param_specs)")
    theta = _convert(theta_L, device) if mesh is None else _blocks(theta_L, specs, mesh, device, 0)
    owners = _convert(bank, device) if mesh is None else _blocks(bank, specs, mesh, device, 1)
    n_owners = {leaf.shape[0] for leaf in tree_flatten(owners)[0]}
    if len(n_owners) != 1:
        raise ValueError(f"bank leaves disagree on the owner axis: {sorted(n_owners)}")
    for leaf, row in zip(tree_flatten(owners)[0], tree_flatten(theta)[0]):
        if tuple(leaf.shape[1:]) != tuple(row.shape):
            raise ValueError(f"a bank leaf of shape {tuple(leaf.shape)} does not hold "
                             f"rows of {tuple(row.shape)}")
    return AsyncDPState(theta, owners, torch.tensor(int(step), dtype=torch.int32, device=device),
                        ledger, tree, faults, stale)
