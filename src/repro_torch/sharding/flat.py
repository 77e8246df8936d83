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

Checkpoints hold GLOBAL arrays, as the reference's `save_checkpoint`
(`np.asarray` of each leaf), and no rank builds one: `stream` sends each
block (`state_blocks` says which leaves are blocks, and along which axes)
to the one writing rank (`writer`) in pieces of a few rows
(`checkpoint.store.PIECE_BYTES`), point to point from the lowest rank
that holds it,
and the writer puts each piece's columns together on the host and writes
it out; the mesh then meets at `barrier`. On restore `to_local` slices
each rank's block out of the file's view of the global array.

Every collective is issued whatever the group's size: on a 1x1 mesh each
group is the rank alone, and the engine runs the code a real mesh runs.
Groups are created once per (mesh, axes) in this world; every rank of the
world takes part in the creation, in the same order, as
`torch.distributed.new_group` requires.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

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

    def to_local(self, full, rows: bool, cols: bool):
        """This rank's block of a global array (a tensor, or a numpy array
        such as a view of a checkpoint file, which is sliced and not read);
        raises ValueError when the array is not of this layout's N or P."""
        if rows:
            if full.shape[0] != self.n:
                raise ValueError(f"{full.shape[0]} rows for a layout of {self.n}")
            full = full[self.r0:self.r0 + self.n_local]
        if cols:
            if full.shape[-1] != self.p:
                raise ValueError(f"{full.shape[-1]} columns for a layout of {self.p}")
            full = full[..., self.c0:self.c0 + self.p_local]
        return full.contiguous() if isinstance(full, torch.Tensor) else full

    @property
    def writer(self) -> bool:
        """Whether this rank writes what the mesh writes once (the mesh's
        lowest global rank)."""
        return dist.get_rank() == int(self.mesh.mesh.min())

    def barrier(self) -> None:
        """Every rank of the mesh meets here."""
        group = _groups(self.mesh, tuple(self.mesh.mesh_dim_names))[0]
        if self.mesh.device_type == "cuda":
            dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)

    def _holders(self, rows: bool, cols: bool) -> Dict[Tuple[int, int], int]:
        """{(row block, column block): the lowest global rank holding it},
        a block index 0 along an axis the leaf is not blocked on."""
        names = tuple(self.mesh.mesh_dim_names)
        sizes = dict(zip(names, self.mesh.mesh.shape))
        out: Dict[Tuple[int, int], int] = {}
        for coord in itertools.product(*(range(sizes[a]) for a in names)):
            at = dict(zip(names, coord))
            b = (_block_index(at, sizes, self.row_axes) if rows else 0,
                 _block_index(at, sizes, self.col_axes) if cols else 0)
            r = int(self.mesh.mesh[coord])
            out[b] = min(out.get(b, r), r)
        return out

    def stream(self, read: Callable[[int, int], torch.Tensor], lead: int, row_shape,
               dtype: torch.dtype, rows: bool, cols: bool, device) -> Iterator[torch.Tensor]:
        """The global array of a blocked leaf, in C order, as host pieces of
        whole leading rows, each the columns of every block put together;
        a collective of the mesh, which every rank iterates to its end (the
        leaves in one order).

        This rank's block is `lead` leading rows of `row_shape` (columns
        last), and `read(a, b)` gives its rows [a, b) (any device). The
        writer yields the pieces and nothing else does: the lowest rank
        holding a block sends each of its pieces to the writer point to
        point through `device` (the backend's), and the writer copies its
        own pieces to the host without a device copy. A piece holds at most
        `checkpoint.store.PIECE_BYTES` of the global array, or one row."""
        from repro_torch.checkpoint.store import rows_per_piece
        writer = int(self.mesh.mesh.min())
        me = dist.get_rank()
        holders = self._holders(rows, cols)
        row_shape = tuple(row_shape)
        n_rb = self.row_blocks if rows else 1
        n_cb = self.col_blocks if cols else 1
        width = row_shape[-1] if row_shape else 1
        g_row = row_shape[:-1] + (width * n_cb,) if cols else row_shape
        itemsize = torch.empty(0, dtype=dtype).element_size()
        k = rows_per_piece(g_row, dtype)
        for rb in range(n_rb):
            for a in range(0, lead, k):
                b = min(lead, a + k)
                out = torch.empty((b - a,) + g_row, dtype=dtype) if me == writer else None
                for cb in range(n_cb):
                    src = holders[(rb, cb)]
                    if me == writer:
                        dst = out[..., cb * width:(cb + 1) * width] if cols else out
                        if src == me:
                            dst.copy_(read(a, b))
                        else:
                            # bytes on the wire: exact, and a dtype every backend sends
                            shape = (b - a,) + row_shape
                            buf = torch.empty(shape[:-1] + (shape[-1] * itemsize,),
                                              dtype=torch.uint8, device=device)
                            dist.recv(buf, src=src)
                            dst.copy_(buf.view(dtype))
                    elif src == me:
                        dist.send(read(a, b).to(device).contiguous().view(torch.uint8),
                                  dst=writer)
                if out is not None:
                    yield out

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


def state_blocks(state) -> Dict[str, Tuple[bool, bool]]:
    """{checkpoint key: (rows, cols)} of the leaves of a meshed flat state
    that are this rank's blocks (`checkpoint.store.flatten_with_paths`
    keys): theta_L's columns; the bank's (a PagedBank's hot tier's) rows and
    columns, or a QuantBank's codes (rows and columns), scales (rows) and
    residual (columns); the tree's node rows and columns. Every other leaf
    (the ledger, the page table, the leaf counts, the fault and runtime
    columns, step) is replicated."""
    from repro_torch.checkpoint.store import flatten_with_paths
    from repro_torch.federation.flatten import PagedBank, QuantBank
    axes = {id(state.theta_L.buf): (False, True)}
    hot = state.bank.hot if isinstance(state.bank, PagedBank) else state.bank
    if isinstance(hot, QuantBank):
        axes.update({id(hot.codes): (True, True), id(hot.scales): (True, False),
                     id(hot.residual): (False, True)})
    else:
        axes[id(hot)] = (True, True)
    if state.tree is not None:
        axes[id(state.tree.nodes)] = (True, True)
    return {k: axes[id(v)] for k, v in flatten_with_paths(state).items() if id(v) in axes}


def stream_leaves(state) -> Dict[str, Any]:
    """{checkpoint key: leaf} of a meshed flat state, as `save_leaves`
    writes it: each block a `Streamed` global array (`FlatLayout.stream`),
    every other leaf the state's own. Every rank of the mesh drives the
    streams, in this order."""
    from repro_torch.checkpoint.store import Streamed, flatten_with_paths
    lay = state.theta_L.layout
    blocks = state_blocks(state)
    out = {}
    for key, x in flatten_with_paths(state).items():
        if key not in blocks:
            out[key] = x
            continue
        rows, cols = blocks[key]
        shape = list(x.shape)
        if rows:
            shape[0] = lay.n
        if cols:
            shape[-1] = lay.p
        y = x.unsqueeze(0) if x.ndim == 1 and not rows else x     # (P_local,): one row
        out[key] = Streamed(tuple(shape), x.dtype, lay.stream(
            lambda a, b, y=y: y[a:b], y.shape[0], y.shape[1:], x.dtype, rows, cols, x.device))
    return out


def layout_for(mesh, n: int, p: int) -> Optional[FlatLayout]:
    """The FlatLayout of an (n, p) flat state on `mesh` (None: no mesh)."""
    if mesh is None:
        return None
    return FlatLayout(flat_shardings(mesh, n, p), n, p)
