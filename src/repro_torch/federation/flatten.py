"""Flat-parameter representation for the deep round engine.

Counterpart of ``repro/federation/flatten.py`` (f32 only so far). The
inertia round is elementwise in every parameter, so the model is packed
into ONE contiguous (P,) f32 buffer and the owner bank becomes one
(N_owners, P) matrix whose gather/scatter is a row copy:

    spec = flatten_spec(params)         # leaf shapes/offsets in jax's order
    flat = pack_params(params)          # ParamFlat: (P,) f32 + spec, on CUDA
    tree = flat.unpack()                # views of flat.buf

Leaf order is jax.tree_util's, not torch's: dicts flatten in SORTED key
order, NamedTuples (and tuples/lists) in field order, and None fields are
dropped. A bank row therefore has the same layout in both packages, which
is what lets a row of one be compared with a row of the other; a different
order would shuffle the layout without failing anywhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Tuple

import torch

from repro_torch.device import resolve_device

_LEAF = "*"


def tree_flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """(leaves, treedef) in jax.tree_util's order; treedef is hashable."""
    leaves: List[torch.Tensor] = []

    def rec(x):
        if x is None:
            return None
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return ("dict", keys, tuple(rec(x[k]) for k in keys))
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return ("namedtuple", type(x), tuple(rec(v) for v in x))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, None, tuple(rec(v) for v in x))
        leaves.append(x)
        return _LEAF

    return leaves, rec(tree)


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def rec(node):
        if node is None:
            return None
        if node == _LEAF:
            return next(it)
        kind, aux, children = node
        built = [rec(c) for c in children]
        if kind == "dict":
            return dict(zip(aux, built))
        if kind == "namedtuple":
            return aux(*built)
        return tuple(built) if kind == "tuple" else list(built)

    return rec(treedef)


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static layout of a packed tree: structure, leaf shapes and offsets."""
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    size: int                              # P = total elements

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    def _leaves(self, tree) -> List[torch.Tensor]:
        leaves, treedef = tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError("tree structure does not match the spec")
        for leaf, shape in zip(leaves, self.shapes):
            if tuple(leaf.shape) != shape:
                raise ValueError(f"leaf shape {tuple(leaf.shape)} != spec {shape}")
            if leaf.dtype != torch.float32:
                raise TypeError(f"leaf dtype {leaf.dtype}: the port packs f32 only")
        return leaves

    def pack(self, tree) -> torch.Tensor:
        """Tree -> (P,) f32 buffer (a copy)."""
        return torch.cat([leaf.reshape(-1) for leaf in self._leaves(tree)])

    def unpack(self, buf: torch.Tensor) -> Any:
        """(P,) f32 buffer -> tree of VIEWS of `buf`. One split op, so the
        gradient w.r.t. `buf` of a loss on the tree is assembled in one
        pass, already packed."""
        if tuple(buf.shape) != (self.size,):
            raise ValueError(f"buffer shape {tuple(buf.shape)} != ({self.size},)")
        sizes = [math.prod(s) for s in self.shapes]
        pieces = torch.split(buf, sizes)
        return tree_unflatten(self.treedef,
                              [p.view(s) for p, s in zip(pieces, self.shapes)])


def flatten_spec(tree) -> FlatSpec:
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot flatten a tree with no tensor leaves")
    shapes, offsets, off = [], [], 0
    for leaf in leaves:
        if leaf.dtype != torch.float32:
            raise TypeError(f"leaf dtype {leaf.dtype}: the port packs f32 only")
        shapes.append(tuple(leaf.shape))
        offsets.append(off)
        off += leaf.numel()
    return FlatSpec(treedef, tuple(shapes), tuple(offsets), off)


class ParamFlat:
    """One contiguous (P,) f32 master copy of a model tree plus its spec."""

    def __init__(self, buf: torch.Tensor, spec: FlatSpec):
        self.buf = buf
        self.spec = spec

    @property
    def size(self) -> int:
        return self.spec.size

    def unpack(self) -> Any:
        return self.spec.unpack(self.buf)

    def replace_buf(self, buf: torch.Tensor) -> "ParamFlat":
        return ParamFlat(buf, self.spec)

    def __repr__(self) -> str:
        return f"ParamFlat(P={self.spec.size}, n_leaves={self.spec.n_leaves})"


def pack_params(tree, spec: FlatSpec = None, device=None) -> ParamFlat:
    """Pack a model tree into a ParamFlat on `device` (CUDA when None; spec
    inferred if omitted)."""
    spec = flatten_spec(tree) if spec is None else spec
    return ParamFlat(spec.pack(tree).to(resolve_device(device)), spec)


def init_flat_bank(flat: ParamFlat, n_owners: int, dtype=None) -> torch.Tensor:
    """(N_owners, P) f32 owner-copy bank, every row the central buffer."""
    if dtype not in (None, torch.float32):
        raise NotImplementedError("narrow and quantized banks wait for a later "
                                  "slice of the port; the bank is f32")
    return flat.buf.unsqueeze(0).expand(n_owners, flat.size).clone()
