"""Carry weights and bank state from the reference package into the port.

    np_params = jax.tree_util.tree_map(np.asarray, jax_params)   # caller side
    params = params_from_numpy(np_params)              # on CUDA; device="cpu" for the CPU
    bank = quant_bank_from_numpy(np.asarray(qb.codes), np.asarray(qb.scales),
                                 np.asarray(qb.residual), qb.codec.fmt)
    tree = tree_noise_from_numpy(np.asarray(tn.nodes), np.asarray(tn.counts), tn.depth)

The input is the reference's parameter tree with every array mapped to
numpy: nested dicts, lists/tuples and NamedTuples (read through their
``_asdict()``, so no jax import is needed here). NamedTuples become the
port's class of the same name (`AttnParams`, `MLPParams`), None fields stay
None, and every array becomes a tensor with the same values and shape.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.federation.deep import TreeNoise
from repro_torch.federation.flatten import BankCodec, QuantBank
from repro_torch.models.attention import AttnParams
from repro_torch.models.mlp import MLPParams

_NAMEDTUPLES = {cls.__name__: cls for cls in (AttnParams, MLPParams)}


def params_from_numpy(tree: Any, device=None) -> Any:
    """The port's params on `device` (CUDA when None)."""
    return _convert(tree, resolve_device(device))


def _convert(tree: Any, device: torch.device) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        name = type(tree).__name__
        if name not in _NAMEDTUPLES:
            raise TypeError(f"no port counterpart for NamedTuple {name!r}")
        return _NAMEDTUPLES[name](**{k: _convert(v, device)
                                     for k, v in tree._asdict().items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


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


def tree_noise_from_numpy(nodes: np.ndarray, counts: np.ndarray, depth: int,
                          device=None) -> TreeNoise:
    """A port TreeNoise on `device` (CUDA when None) from a reference flat
    TreeNoise's arrays: the (N, depth, P) f32 nodes and the (N,) int32 leaf
    counts."""
    device = resolve_device(device)
    nodes = np.asarray(nodes, dtype=np.float32)
    counts = np.asarray(counts, dtype=np.int32)
    if nodes.ndim != 3 or nodes.shape[1] != depth or counts.shape != nodes.shape[:1]:
        raise ValueError(f"nodes {nodes.shape} and counts {counts.shape} are not a "
                         f"flat depth-{depth} tree")
    return TreeNoise(torch.from_numpy(nodes.copy()).to(device),
                     torch.from_numpy(counts.copy()).to(device), int(depth))
