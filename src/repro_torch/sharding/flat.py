"""The flat engine's state as explicit local blocks on a device mesh.

`FlatLayout` turns the flat rules (`rules.flat_shardings` on a live
DeviceMesh, for N owner rows and P columns) into this rank's blocks and
the process groups the round needs:

    layout = FlatLayout(flat_shardings(mesh, N, P), N, P)
    layout.rows, layout.cols        # this rank's slices of [0, N) and [0, P)
    bank_block = bank[layout.rows, layout.cols]   # what the rank stores

The owner axis splits over the spec's owner axes into `row_blocks` equal
blocks, P over its P axes into `col_blocks`; a dim sharded over several
axes is split major to minor in the spec's order (("model", "data") puts
"model" major, as jax does), so the block map is computed here from the
spec and not left to DTensor's placements, which are data-major. An axis
the spec does not name replicates: the ranks along it hold the same block
and compute the same values.

Two kinds of group serve the round:

  * the ROW group: the ranks that hold my columns for every row block (my
    coordinates on every axis but the owner axes). A row is gathered over
    it: each rank contributes its local candidate and the owner's block is
    selected on the device (`pick`), so no owner index is read back to the
    host and a -0.0 stays -0.0.
  * the COL group: the ranks that hold my rows for every column block. theta
    is gathered over it for the loss (`gather_cols`) and the exact
    reductions run over it: the NaN-keeping max (`max_cols`), the int64
    sum (`sum_cols`) and the logical and (`all_cols`), each an all-gather
    of the partials reduced by torch on the device (NCCL's and gloo's MAX
    do not promise `nan_max`'s rule, and an int32 sum must wrap as the
    reference's bit-sum does).

Every collective is issued whatever the group's size: on a 1x1 mesh each
group is the rank alone, and the engine runs the code a real mesh runs.
Groups are created once per (mesh, axes) in this world; every rank of the
world takes part in the creation, in the same order, as
`torch.distributed.new_group` requires.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import FlatShardings, flat_shardings, mesh_shape

_GROUPS: Dict[tuple, tuple] = {}
_GROUPS_WORLD = [None]


def _axes(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (None -> ())."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _block_index(coord: Dict[str, int], sizes: Dict[str, int], axes) -> int:
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)


def _groups(mesh, axes: Tuple[str, ...]):
    """(my group, the order of its members' blocks) for the ranks that differ
    from me only on `axes`; created for the whole world on first use."""
    if _GROUPS_WORLD[0] is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS_WORLD[0] = dist.group.WORLD
    ranks = mesh.mesh
    names = tuple(mesh.mesh_dim_names)
    key = (tuple(ranks.reshape(-1).tolist()), tuple(ranks.shape), names, axes)
    if key not in _GROUPS:
        sizes = dict(zip(names, ranks.shape))
        others = [a for a in names if a not in axes]
        me = dist.get_rank()
        mine = None
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            members: List[Tuple[int, int]] = []     # (global rank, block index)
            for free in itertools.product(*(range(sizes[a]) for a in axes)):
                coord = dict(zip(others, fixed))
                coord.update(zip(axes, free))
                r = int(ranks[tuple(coord[a] for a in names)])
                members.append((r, _block_index(coord, sizes, axes)))
            members.sort()
            group = dist.new_group([r for r, _ in members])
            if any(r == me for r, _ in members):
                # all_gather stacks in group-rank (sorted global rank) order;
                # order[b] is the stacked position of block b
                order = [0] * len(members)
                for pos, (_, b) in enumerate(members):
                    order[b] = pos
                mine = (group, order)
        _GROUPS[key] = mine
    return _GROUPS[key]


class FlatLayout:
    """This rank's block of the flat state and the groups of its round (see
    the module docstring). `n` is the bank's row count (n_hot on a paged
    bank), `p` the flat parameter count."""

    def __init__(self, shardings: FlatShardings, n: int, p: int):
        mesh = shardings.bank.mesh
        shape = mesh_shape(mesh)
        bank_spec = tuple(shardings.bank.spec) + (None, None)
        self.mesh = mesh
        self.n, self.p = int(n), int(p)
        self.row_axes, self.col_axes = _axes(bank_spec[0]), _axes(bank_spec[1])
        coord_list = mesh.get_coordinate()
        if coord_list is None:
            raise ValueError(f"rank {dist.get_rank()} is not on the mesh {mesh}")
        coord = dict(zip(shape.axis_names, coord_list))
        self.row_blocks = math.prod(shape.shape[a] for a in self.row_axes)
        self.col_blocks = math.prod(shape.shape[a] for a in self.col_axes)
        if self.n % self.row_blocks or self.p % self.col_blocks:
            raise ValueError(f"the layout does not divide ({self.n}, {self.p}) into "
                             f"{self.row_blocks} x {self.col_blocks} blocks")
        self.n_local = self.n // self.row_blocks
        self.p_local = self.p // self.col_blocks
        self.r0 = _block_index(coord, shape.shape, self.row_axes) * self.n_local
        self.c0 = _block_index(coord, shape.shape, self.col_axes) * self.p_local
        self.rows = slice(self.r0, self.r0 + self.n_local)
        self.cols = slice(self.c0, self.c0 + self.p_local)
        self._row_group, self._row_order = _groups(mesh, self.row_axes)
        self._col_group, self._col_order = _groups(mesh, self.col_axes)
        self._order_t: Dict[tuple, torch.Tensor] = {}

    def __repr__(self) -> str:
        return (f"FlatLayout(N={self.n}, P={self.p}, rows={self.r0}:{self.r0 + self.n_local}, "
                f"cols={self.c0}:{self.c0 + self.p_local}, blocks={self.row_blocks}x"
                f"{self.col_blocks})")

    # ------------------------------ blocks ---------------------------------
    def local(self, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(local row index, held) of global row indices (any shape, on the
        device): the index clamped into this rank's block, always a safe
        gather index, and whether the row is this rank's."""
        held = (idx >= self.r0) & (idx < self.r0 + self.n_local)
        return torch.clamp(idx - self.r0, 0, self.n_local - 1), held

    def col_slice(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a (..., P) tensor, contiguous (the tensor
        itself when the columns are all of it)."""
        return full.narrow(-1, self.c0, self.p_local).contiguous()

    # ---------------------------- collectives ------------------------------
    def _gather(self, x: torch.Tensor, group, order) -> torch.Tensor:
        """(G, *x.shape): the members' x stacked in block order."""
        flat = x.reshape(-1).contiguous()
        out = torch.empty(len(order) * flat.numel(), dtype=x.dtype, device=x.device)
        _all_gather(out, flat, group)
        out = out.view((len(order),) + tuple(x.shape))
        if order != list(range(len(order))):
            k = (x.device, tuple(order))
            if k not in self._order_t:
                self._order_t[k] = torch.tensor(order, dtype=torch.int64, device=x.device)
            out = out.index_select(0, self._order_t[k])
        return out

    def pick(self, local_rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The true rows of global row indices `idx` ((g,) int64): every rank
        of the row group contributes `local_rows` ((g, ...), its candidate
        rows at `local(idx)`), and row m comes from the block that holds
        idx[m]. Exact for every dtype (a gather, no arithmetic)."""
        stacked = self._gather(local_rows, self._row_group, self._row_order)  # (R, g, ...)
        blk = torch.div(idx, self.n_local, rounding_mode="floor")
        return stacked[blk, torch.arange(idx.numel(), device=idx.device)]

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """(..., P) from this rank's (..., P_local) columns."""
        stacked = self._gather(x, self._col_group, self._col_order)     # (C, ..., Pl)
        return torch.movedim(stacked, 0, -2).reshape(tuple(x.shape[:-1]) + (self.p,))

    def max_cols(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max of `x` over the column blocks; a NaN in any block
        wins, as torch.amax and jnp.max keep it."""
        return torch.amax(self._gather(x, self._col_group, self._col_order), dim=0)

    def sum_cols(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum of an integer `x` over the column blocks (exact)."""
        return torch.sum(self._gather(x, self._col_group, self._col_order), dim=0,
                         dtype=x.dtype)

    def all_cols(self, flag: torch.Tensor) -> torch.Tensor:
        """Logical and of a bool `flag` over the column blocks."""
        parts = self._gather(flag.to(torch.uint8), self._col_group, self._col_order)
        return torch.all(parts.bool(), dim=0)


def layout_for(mesh, n: int, p: int) -> Optional[FlatLayout]:
    """The FlatLayout of an (n, p) flat state on `mesh` (None: no mesh)."""
    if mesh is None:
        return None
    return FlatLayout(flat_shardings(mesh, n, p), n, p)
