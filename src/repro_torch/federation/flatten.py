"""Flat-parameter representation for the deep round engine.

Counterpart of ``repro/federation/flatten.py``. The inertia round is
elementwise in every parameter, so the model is packed into ONE contiguous
(P,) f32 buffer and the owner bank becomes one (N_owners, P) matrix whose
gather/scatter is a row copy:

    spec = flatten_spec(params)         # leaf shapes/dtypes/offsets in jax's order
    flat = pack_params(params)          # ParamFlat: (P,) f32 + spec, on CUDA
    tree = flat.unpack()                # leaves in their dtypes (f32: views of flat.buf)
    noise = spec.unpack_f32(buf)        # f32 views (pack_f32 is its inverse)
    bank = init_flat_bank(flat, N)      # (N, P) f32; bf16, f16, or "int8"/"fp8"
    paged = PagedBank(hot, hot_ids, N)  # n_hot resident rows (federation.paging)

Leaves may be f32, bf16 or f16 (`_PACKABLE`, as the reference's
`_check_dtype`): both narrow floats embed exactly in f32, so `pack` widens
each leaf to the buffer without losing a bit and `unpack` narrows it back
exactly. An f32 leaf unpacks to a VIEW of the buffer; a bf16 or f16 leaf to
a differentiable cast of its slice, so the buffer's gradient is the leaf
gradient widened to f32. Any other dtype raises TypeError.

On a device mesh (`sharding.flat.FlatLayout`) every buffer is this rank's
local block: `pack_params(..., layout=)` keeps the rank's columns of the
packed row (`ParamFlat.layout` says which), and `init_flat_bank` builds
the rank's rows of the bank over them.

The bank's storage follows `bank_dtype`: f32 (the default), a dense
torch.bfloat16 or torch.float16 matrix (or the names "float32", "bfloat16",
"float16"), or a `QuantBank` of 1-byte int8 / fp8 codes with
one f32 scale per row and a shared error-feedback residual row. A
`PagedBank` keeps only n_hot of the N rows on the device, behind a page
table (`federation.paging` moves rows between it and the host).

Leaf order is jax.tree_util's, not torch's: dicts flatten in SORTED key
order, NamedTuples (and tuples/lists) in field order, and None fields are
dropped. A bank row therefore has the same layout in both packages, which
is what lets a row of one be compared with a row of the other; a different
order would shuffle the layout without failing anywhere (the walk lives in
`repro_torch.tree_util`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.tree_util import tree_flatten, tree_unflatten

# leaf dtypes that embed exactly in the f32 buffer, and the names the
# reference accepts for them (numpy's)
_PACKABLE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _check_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in _PACKABLE.values():
        raise TypeError(f"cannot pack dtype {dtype} into the f32 flat buffer without losing "
                        f"bits (packable: {', '.join(_PACKABLE)})")
    return dtype


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static layout of a packed tree: structure, leaf shapes, dtypes and
    offsets."""
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]        # f32, bf16 or f16 per leaf
    offsets: Tuple[int, ...]
    size: int                              # P = total elements

    @property
    def n_leaves(self) -> int:
        return len(self.shapes)

    def _leaves(self, tree) -> List[torch.Tensor]:
        leaves, treedef = tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError("tree structure does not match the spec")
        for leaf, shape, dt in zip(leaves, self.shapes, self.dtypes):
            if tuple(leaf.shape) != shape:
                raise ValueError(f"leaf shape {tuple(leaf.shape)} != spec {shape}")
            if leaf.dtype != dt:
                raise TypeError(f"leaf dtype {leaf.dtype} != spec {dt}")
        return leaves

    def pack(self, tree) -> torch.Tensor:
        """Tree -> (P,) f32 buffer (a copy), each leaf widened exactly."""
        return torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in self._leaves(tree)])

    def _split(self, buf: torch.Tensor):
        """(P,) buffer -> its pieces, each a view with its leaf's shape."""
        if tuple(buf.shape) != (self.size,):
            raise ValueError(f"buffer shape {tuple(buf.shape)} != ({self.size},)")
        pieces = torch.split(buf, [math.prod(s) for s in self.shapes])
        return [p.view(s) for p, s in zip(pieces, self.shapes)]

    def unpack(self, buf: torch.Tensor) -> Any:
        """(P,) f32 buffer -> tree of the spec's leaves: f32 leaves are
        VIEWS of `buf`, bf16 and f16 leaves casts of their slices. One split
        op, so the gradient w.r.t. `buf` of a loss on the tree is assembled
        in one pass, already packed (a narrow leaf's gradient widened)."""
        return tree_unflatten(self.treedef, [p.to(dt) for p, dt
                                             in zip(self._split(buf), self.dtypes)])

    def pack_f32(self, tree) -> torch.Tensor:
        """Tree with the spec's shapes (any floating dtype) -> (P,) f32
        buffer (a copy); shapes are checked, dtypes are not."""
        leaves, treedef = tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError("tree structure does not match the spec")
        for leaf, shape in zip(leaves, self.shapes):
            if tuple(leaf.shape) != shape:
                raise ValueError(f"leaf shape {tuple(leaf.shape)} != spec {shape}")
        return torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])

    def unpack_f32(self, buf: torch.Tensor) -> Any:
        """(P,) f32 buffer -> tree of f32 views of `buf` with the spec's
        shapes, whatever the leaves' dtypes (no per-leaf cast: side-channel
        rows such as the tree's noise stay f32)."""
        return tree_unflatten(self.treedef, self._split(buf.to(torch.float32)))


def flatten_spec(tree) -> FlatSpec:
    """The spec of a tree of f32, bf16 or f16 leaves (any other dtype
    raises TypeError, as the reference's _check_dtype)."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot flatten a tree with no tensor leaves")
    shapes, dtypes, offsets, off = [], [], [], 0
    for leaf in leaves:
        dtypes.append(_check_dtype(leaf.dtype))
        shapes.append(tuple(leaf.shape))
        offsets.append(off)
        off += leaf.numel()
    return FlatSpec(treedef, tuple(shapes), tuple(dtypes), tuple(offsets), off)


class ParamFlat:
    """One contiguous (P,) f32 master copy of a model tree plus its spec.

    On a device mesh `layout` (a `sharding.flat.FlatLayout`) is set and
    `buf` holds this rank's columns only, `layout.cols` of the (P,) row;
    `size` stays the whole P. `full()` gathers the row (a collective)."""

    def __init__(self, buf: torch.Tensor, spec: FlatSpec, layout=None):
        self.buf = buf
        self.spec = spec
        self.layout = layout

    @property
    def size(self) -> int:
        return self.spec.size

    def full(self) -> torch.Tensor:
        """The whole (P,) buffer: `buf` itself, or on a mesh its columns
        gathered over the layout's column group."""
        return self.buf if self.layout is None else self.layout.gather_cols(self.buf)

    def unpack(self) -> Any:
        return self.spec.unpack(self.full())

    def replace_buf(self, buf: torch.Tensor) -> "ParamFlat":
        return ParamFlat(buf, self.spec, self.layout)

    def __repr__(self) -> str:
        where = "" if self.layout is None else f", cols={self.layout.cols}"
        return f"ParamFlat(P={self.spec.size}, n_leaves={self.spec.n_leaves}{where})"


def pack_params(tree, spec: FlatSpec = None, device=None, layout=None) -> ParamFlat:
    """Pack a model tree into a ParamFlat on `device` (CUDA when None; spec
    inferred if omitted). With a `layout` the buffer is this rank's
    columns."""
    spec = flatten_spec(tree) if spec is None else spec
    buf = spec.pack(tree)
    if layout is not None:
        buf = layout.col_slice(buf).contiguous()
    return ParamFlat(buf.to(resolve_device(device)), spec, layout)


_QUANT_FMTS = ("int8", "fp8")


@dataclasses.dataclass(frozen=True)
class BankCodec:
    """Configuration of a quantized owner bank.

    fmt          -- "int8" (symmetric linear code, q in [-127, 127]) or
                    "fp8" (float8_e4m3fn grid, raw uint8 patterns); 1 byte
                    per element either way.
    block_elems  -- None: one f32 scale per bank row (the only layout the
                    kernels take). An int cuts each row into
                    ceil(P / block_elems) segments with a scale each (the
                    plain version only, on the CPU).
    """
    fmt: str
    block_elems: Optional[int] = None

    def __post_init__(self):
        if self.fmt not in _QUANT_FMTS:
            raise ValueError(f"unknown bank codec {self.fmt!r} "
                             f"(supported: {', '.join(_QUANT_FMTS)})")
        if self.block_elems is not None and self.block_elems < 1:
            raise ValueError(f"block_elems must be >= 1, got {self.block_elems}")


def as_bank_codec(dtype) -> Optional[BankCodec]:
    """Normalize a `bank_dtype` option: "int8"/"fp8" (or a BankCodec) mean
    the quantized bank; None and a packable float (torch.float32,
    torch.bfloat16, torch.float16, or their names "float32", "bfloat16",
    "float16") mean the dense bank (returns None). An unknown string or
    dtype raises ValueError."""
    if isinstance(dtype, BankCodec):
        return dtype
    if isinstance(dtype, str):
        if dtype in _QUANT_FMTS:
            return BankCodec(dtype)
        if dtype not in _PACKABLE:
            raise ValueError(f"unknown bank_dtype {dtype!r}: expected a floating dtype "
                             f"({', '.join(_PACKABLE)}) or a quantized format "
                             f"({', '.join(_QUANT_FMTS)})")
        return None
    if dtype is not None and dtype not in _PACKABLE.values():
        raise ValueError(f"bank_dtype {dtype} is not a bank storage the port has "
                         f"({', '.join(_PACKABLE)}, {', '.join(_QUANT_FMTS)})")
    return None


def _dense_dtype(dtype) -> torch.dtype:
    """The torch dtype of a dense bank's rows: None means f32, a name
    ("bfloat16", ...) its torch dtype."""
    if dtype is None:
        return torch.float32
    return _PACKABLE[dtype] if isinstance(dtype, str) else dtype


class QuantBank:
    """Quantized owner bank: (N_owners, P) 1-byte codes, (N_owners, nb) f32
    scales and ONE shared (P,) f32 error-feedback residual row.

    The residual holds the quantization error of the last granted write;
    the engine adds it to the next granted update before encoding, so the
    error is fed back instead of lost. A refused round leaves codes, scales
    AND residual untouched. The engine updates all three in place.

    Resident bytes: N*P (codes) + 4*N*nb (scales) + 4*P (residual).
    """

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor,
                 residual: torch.Tensor, codec: BankCodec):
        self.codes = codes
        self.scales = scales
        self.residual = residual
        self.codec = codec

    @property
    def n_owners(self) -> int:
        return self.codes.shape[0]

    @property
    def size(self) -> int:
        return self.codes.shape[-1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.codes, self.scales, self.residual))

    def decode_rows(self) -> torch.Tensor:
        """(N, P) f32 view of every owner copy (tests and inspection; on
        CUDA this launches one decode per row)."""
        from repro_torch.kernels.bank_codec.ops import decode_row
        return torch.stack([decode_row(c, s, self.codec.fmt, block_elems=self.codec.block_elems)
                            for c, s in zip(self.codes, self.scales)])

    def replace(self, **kw) -> "QuantBank":
        args = {"codes": self.codes, "scales": self.scales,
                "residual": self.residual, "codec": self.codec}
        args.update(kw)
        return QuantBank(**args)

    def __repr__(self) -> str:
        return f"QuantBank(fmt={self.codec.fmt!r}, N={self.n_owners}, P={self.size})"


class PagedBank:
    """Paged owner bank: a device-resident working set of `n_hot` rows over
    a host cold tier (see ``federation.paging``).

    `hot` is the resident tier: a dense (n_hot, P) matrix or a QuantBank
    with n_hot rows (its error-feedback residual belongs to the session,
    not to an owner, and never pages). `hot_ids` is the page table on the
    device: a SORTED (n_hot,) int32 vector of the owner resident in each
    slot, with the sentinel `n_owners` in empty slots (it sorts after every
    real id, so the table stays sorted). Resident bytes are O(n_hot * P),
    whatever N is.

    `lookup` resolves owner -> slot on the device with `torch.searchsorted`
    over the table, with no host read, and returns a `hit` mask that the
    drivers fold into their grant: a round of an owner that is not resident
    is a bit-exact masked no-op, counted as a refusal."""

    def __init__(self, hot, hot_ids: torch.Tensor, n_owners: int):
        self.hot = hot
        self.hot_ids = hot_ids
        self.n_owners = n_owners

    @property
    def n_hot(self) -> int:
        return self.hot_ids.shape[0]

    @property
    def size(self) -> int:
        return self.hot.size if isinstance(self.hot, QuantBank) else self.hot.shape[-1]

    @property
    def codec(self) -> Optional[BankCodec]:
        return self.hot.codec if isinstance(self.hot, QuantBank) else None

    @property
    def nbytes(self) -> int:
        """Device-resident bytes: the hot tier and the page table."""
        hot = (self.hot.nbytes if isinstance(self.hot, QuantBank)
               else self.hot.numel() * self.hot.element_size())
        return hot + self.hot_ids.numel() * self.hot_ids.element_size()

    def lookup(self, owner_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """owner ids (any shape, any int dtype, on the table's device) ->
        (slot int64, hit bool), both shaped like `owner_idx`.

        The slot is searchsorted's left insertion point (as
        jnp.searchsorted's), clamped into [0, n_hot): always a safe gather
        index. `hit` is False where the owner is not resident; the clamped
        slot then holds another owner's row, which the drivers' masked
        writes leave bit-exactly as it was. The query is cast to the
        table's int32; the table itself is never cast."""
        q = owner_idx.to(self.hot_ids.dtype)
        slot = torch.searchsorted(self.hot_ids, q.reshape(-1))
        slot = torch.clamp(slot, max=self.n_hot - 1)
        hit = self.hot_ids.index_select(0, slot) == q.reshape(-1)
        return slot.reshape(owner_idx.shape), hit.reshape(owner_idx.shape)

    def replace(self, **kw) -> "PagedBank":
        args = {"hot": self.hot, "hot_ids": self.hot_ids, "n_owners": self.n_owners}
        args.update(kw)
        return PagedBank(**args)

    def __repr__(self) -> str:
        fmt = self.codec.fmt if self.codec is not None else str(self.hot.dtype)
        return (f"PagedBank(n_hot={self.n_hot}, N={self.n_owners}, P={self.size}, "
                f"storage={fmt!r})")


def sliced_scales(value: torch.Tensor, codec: "BankCodec", layout) -> torch.Tensor:
    """The whole row's scales of a row whose columns from `layout.c0` this
    rank holds (`value`): the (1,) row scale from the column group's
    partial absmaxes, or under per-block scales the (nb,) block scales,
    each block's partials (this rank's columns of it) reduced over the
    column group, so a block that straddles ranks takes its max over all
    of them. NaN is kept, as the unmeshed scales keep it."""
    from repro_torch.kernels.bank_codec.ops import (block_absmax, block_scales_from_absmax,
                                                    n_scales, row_absmax, scale_from_absmax)
    be = codec.block_elems
    if be is None:
        return scale_from_absmax(layout.max_cols(row_absmax(value)), codec.fmt)
    parts = block_absmax(value, be, layout.c0, n_scales(layout.p, be))
    return block_scales_from_absmax(layout.max_cols(parts), codec.fmt)


def init_flat_bank(flat: ParamFlat, n_owners: int, dtype=None):
    """(N_owners, P) owner-copy bank, every row the central buffer.

    `dtype` is the bank's storage: None or torch.float32 (f32 rows),
    torch.bfloat16 or torch.float16 (rows upcast on gather and narrowed on
    write; a refused row round-trips exactly; also by name, "bfloat16"), or
    "int8"/"fp8"/a BankCodec for a QuantBank.
    The quantized bank encodes the central row ONCE with the deterministic
    round-to-nearest and copies its codes N times, so no (N, P) f32 tensor
    ever exists; the residual starts at zero.

    On a mesh (`flat.layout` set) the bank is this rank's block: its rows
    of the N (`layout.n_local`) over the columns `flat.buf` holds; a
    quantized row is encoded from its columns with the whole row's scale
    (the partial absmaxes reduced over the column group), or with
    per-block scales each block's, a block that straddles ranks reduced
    over the column group too (`sliced_scales`)."""
    codec = as_bank_codec(dtype)
    layout = flat.layout
    n_rows = n_owners if layout is None else layout.n_local
    p = flat.buf.shape[0]
    if codec is not None:
        from repro_torch.kernels.bank_codec.ops import encode_row
        kw = {} if layout is None else dict(col0=layout.c0,
                                            scale=sliced_scales(flat.buf, codec, layout))
        codes_row, scales_row, _ = encode_row(flat.buf, None, codec.fmt,
                                              block_elems=codec.block_elems,
                                              deterministic=True, **kw)
        return QuantBank(codes_row.unsqueeze(0).expand(n_rows, p).clone(),
                         scales_row.unsqueeze(0).expand(n_rows, -1).clone(),
                         torch.zeros_like(flat.buf), codec)
    bank = torch.empty((n_rows, p), dtype=_dense_dtype(dtype), device=flat.buf.device)
    return bank.copy_(flat.buf.unsqueeze(0).expand(n_rows, p))
