"""The model zoo's operations on DTensors: what DTensor's own sharding
propagation does not do for the LM.

    y = einsum("bsd,dhk->bshk", x, w)           # any mix of tensors and DTensors
    o = local_map(fn, (q, k, v), dims, out_dims, mesh, batch=True, heads=True)
    write_slot(cache.k, 1, slot, k_new)          # a KV-cache write in place

On plain tensors `einsum` is ``torch.einsum`` and nothing else here runs,
so the unmeshed model is unchanged bit for bit.

`einsum` shards a product by its letters, as GSPMD does a dot: on each
mesh dim one of the letters that the operands shard there is kept (the
one whose layout moves the fewest bytes), every operand that has that
letter is sharded on it too (a local slice when it was replicated) and
every other operand is gathered on that mesh dim. The product then runs
on each rank's pieces with ``torch.einsum``, and the result is sharded on
the kept letter where the output has it; where the letter is contracted
the ranks' partial sums are all-reduced at once, in the output's dtype
(left partial, DTensor would carry it into the residual stream and
reduce it later in f32). So
the work is always split, FSDP weights are gathered against a large
batch, a small decode batch is moved to the weights instead, and a
tensor-parallel down projection leaves a partial sum. DTensor's own
einsum would reshape sharded dims, which it refuses.

`local_map` runs a function on each rank's local pieces, the inputs laid
out by two roles: the batch over the data axes ("pod", "data") and the
heads over "model"; every other dim is replicated. It is
``torch.distributed.tensor.experimental.local_map`` with the placements
worked out from the roles, and it serves the kernels' entry points (flash
attention, the SSD scan) and the loops that are cheaper on plain tensors
(the sLSTM's positions).

Each of them is differentiable. Where a region splits its work over a
mesh dim (a kept letter, a vocabulary block, the batch or the heads), an
input replicated on that dim takes only this rank's share of the work, so
its local gradient is a partial sum: it leaves the region as `Partial`
there (``to_local(grad_placements=...)``) and is reduced where the
input's own layout asks for it. `cross_entropy` is the LM loss's
per-position term on logits whose vocabulary is sharded.

A mesh dim of size 1 splits nothing, so on the 1x1 mesh every local piece
is the whole tensor and every collective acts on a group of one.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

__all__ = ["all_true", "as_dtensor", "cross_entropy", "data_dims", "einsum", "embedding",
           "is_dtensor", "keep_grad_layout", "like", "local_block", "local_map", "mesh_of",
           "model_dim", "on_heads", "plain",
           "put_rows_", "reduced", "replicating", "shards", "take_row", "tree_total",
           "with_owner_axis", "write_slot"]


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def mesh_of(*ts):
    """The DeviceMesh of the first DTensor among `ts`, or None."""
    for t in ts:
        if t is not None and is_dtensor(t):
            return t.device_mesh
    return None


def data_dims(mesh) -> Tuple[int, ...]:
    """The mesh dims of the data axes ("pod", "data"), in mesh order."""
    names = tuple(mesh.mesh_dim_names)
    return tuple(i for i, n in enumerate(names) if n in ("pod", "data"))


def model_dim(mesh) -> Optional[int]:
    names = tuple(mesh.mesh_dim_names)
    return names.index("model") if "model" in names else None


def replicating(*ts):
    """A context in which plain tensors meet DTensors as replicated ones
    (``implicit_replication``) when any of `ts` is a DTensor; else a no-op.
    The model's own constants (positions, masks, zero states) are the same
    on every rank, so that is what they are. Re-entrant: leaving an inner
    context keeps the outer one's replication (``implicit_replication``
    alone switches it off on every exit)."""
    if mesh_of(*ts) is None:
        return contextlib.nullcontext()
    return _replicating()


# the depth of the open `replicating` contexts (torch's flag is per process)
_REPLICATING = [0]


@contextlib.contextmanager
def _replicating():
    from torch.distributed.tensor.experimental import implicit_replication
    _REPLICATING[0] += 1
    try:
        if _REPLICATING[0] == 1:
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _REPLICATING[0] -= 1


def _size(mesh, dims) -> int:
    n = 1
    for d in dims:
        n *= mesh.size(d)
    return n


def _replicated(mesh, t: torch.Tensor):
    """A plain tensor (the same on every rank) as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def as_dtensor(mesh, t):
    """`t` as a DTensor on `mesh` (a plain tensor as a replicated one)."""
    return t if is_dtensor(t) else _replicated(mesh, t)


def reduced(t):
    """`t` with every partial sum reduced (replicated on those mesh dims)."""
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


class _KeepGradLayout(torch.autograd.Function):
    """Identity whose backward hands the gradient back laid out as the
    forward's tensor was."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if is_dtensor(grad) and tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def keep_grad_layout(t: torch.Tensor) -> torch.Tensor:
    """`t`, whose gradient reaches the ops before it laid out as `t` is.
    DTensor's ops may hand a gradient back sharded where the forward
    tensor was replicated (an elementwise op beside a sharded operand
    shards it); after a reshape that merged a dim the mesh does not divide
    (heads that do not split over "model"), the reshape's backward could
    not split such a gradient, so the merged tensor passes through here.
    A plain tensor is returned as it is."""
    return _KeepGradLayout.apply(t) if is_dtensor(t) else t


def plain(t):
    """A replicated DTensor's local tensor (the same on every rank);
    anything else as it is."""
    return reduced(t).to_local() if is_dtensor(t) else t


def local_block(t) -> Tuple[torch.Tensor, Tuple[int, ...], Tuple[int, ...]]:
    """(this rank's block of the DTensor t, t's global shape, the block's
    offset in it), partial sums reduced first."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    t = reduced(t)
    _, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return t.to_local(), tuple(t.shape), tuple(int(o) for o in offset)


def like(t, local: torch.Tensor):
    """`local` as this rank's block of a DTensor laid out as t."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _shifted(placements, by: int):
    """Placements of a tensor with `by` dims added (> 0) or dropped (< 0)
    in front; a dropped dim must be replicated."""
    from torch.distributed.tensor import Shard
    out = []
    for p in placements:
        if p.is_shard():
            if p.dim + by < 0:
                raise ValueError(f"{p} shards a dim that is dropped")
            p = Shard(p.dim + by)
        out.append(p)
    return out


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of `shape` (a DTensor's global
    stride, which its local block's does not give where a dim is split)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def with_owner_axis(leaf, rows: torch.Tensor, *lead: int):
    """`rows` (*lead, *this rank's block of leaf) as a DTensor of (*lead,
    *leaf.shape): the leading axes (the owners; a noise tree's owners and
    levels) replicated, the rest laid out as the DTensor `leaf`."""
    from torch.distributed.tensor import DTensor
    shape = tuple(lead) + tuple(leaf.shape)
    return DTensor.from_local(rows, leaf.device_mesh, _shifted(leaf.placements, len(lead)),
                              run_check=False, shape=shape, stride=contiguous_stride(shape))


def take_row(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t.index_select(0, idx)[0] for a one-element int64 `idx`; on a
    DTensor whose leading axis is replicated, each rank takes the row of
    its own block (no collective)."""
    if not is_dtensor(t):
        return t.index_select(0, idx)[0]
    from torch.distributed.tensor import DTensor
    local = t.to_local().index_select(0, idx)[0]
    shape = tuple(t.shape[1:])
    return DTensor.from_local(local, t.device_mesh, _shifted(t.placements, -1),
                              run_check=False, shape=shape, stride=contiguous_stride(shape))


def put_rows_(t: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """t.index_copy_(0, idx, rows) IN PLACE; on a DTensor whose leading
    axis is replicated, `rows` is laid out as t and each rank writes its
    block of every row into its own block of t."""
    if not is_dtensor(t):
        t.index_copy_(0, idx, rows)
        return
    rows = reduced(as_dtensor(t.device_mesh, rows))
    if tuple(rows.placements) != tuple(t.placements):
        rows = rows.redistribute(t.device_mesh, t.placements)
    t.to_local().index_copy_(0, idx, rows.to_local())


def tree_total(leaves: Sequence[torch.Tensor], fn: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
    """sum(fn(leaf) for leaf in leaves), in leaf order, for an `fn` that
    sums over its leaf (a result additive over blocks, of one shape for
    every leaf: a sum of squares, the int64 bit sums of some rows). On
    DTensor leaves fn runs on each rank's block; the blocks' values of the
    leaves sharded on the same mesh dims are summed over those dims in one
    all-reduce (a dim the leaf is replicated on is counted once), and the
    leaves' totals are then added in leaf order on every rank, so the 1x1
    mesh gives the unmeshed value bit for bit. The result is then a
    replicated DTensor."""
    mesh = mesh_of(*leaves)
    if mesh is None:
        return sum(fn(leaf) for leaf in leaves)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    leaves = [reduced(as_dtensor(mesh, leaf)) for leaf in leaves]
    parts = [fn(leaf.to_local()) for leaf in leaves]
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        dims = tuple(m for m, p in enumerate(leaf.placements) if p.is_shard())
        groups.setdefault(dims, []).append(i)
    totals: list = [None] * len(leaves)
    for dims, idx in groups.items():
        stacked = torch.stack([parts[i] for i in idx])
        if dims:
            place = [Partial() if m in dims else Replicate() for m in range(mesh.ndim)]
            stacked = reduced(DTensor.from_local(stacked, mesh, place,
                                                 run_check=False)).to_local()
        for j, i in enumerate(idx):
            totals[i] = stacked[j]
    return _replicated(mesh, sum(totals))


def all_true(flags: torch.Tensor, mesh) -> torch.Tensor:
    """The logical and of a plain bool tensor over every rank of `mesh`
    (elementwise; each rank's flags of its own blocks); on no mesh the
    flags as they are."""
    if mesh is None:
        return flags
    from torch.distributed.tensor import DTensor, Partial
    low = DTensor.from_local(flags.to(torch.int32), mesh, [Partial("min")] * mesh.ndim,
                             run_check=False)
    return reduced(low).to_local() != 0


def _local(t, split) -> torch.Tensor:
    """t.to_local() whose gradient is a partial sum on each mesh dim in
    `split` where t is replicated (this rank did only its share of the
    work there), and laid out as t elsewhere."""
    from torch.distributed.tensor import Partial
    grad = [Partial() if m in split and p.is_replicate() else p
            for m, p in enumerate(t.placements)]
    return t.to_local(grad_placements=grad)


def _plan(subs, out: str, ops, mesh):
    """The letter each mesh dim keeps for a product (None where no operand
    is sharded): of the letters the operands shard there, the one that
    moves the fewest bytes. Keeping a letter splits the product's work
    over that mesh dim; it gathers every operand sharded there on another
    letter, costs nothing for one that is replicated (a local slice), and
    leaves partial sums of the output to all-reduce when the letter is
    contracted."""
    size = {c: n for sub, o in zip(subs, ops) for c, n in zip(sub, o.shape)}
    out_bytes = max(o.element_size() for o in ops)
    for c in out:
        out_bytes *= size[c]
    keep = []
    for m in range(mesh.ndim):
        best, best_cost = None, None
        for sub, o in zip(subs, ops):
            p = o.placements[m]
            if not p.is_shard():
                continue
            c = sub[p.dim]
            cost = sum(q.numel() * q.element_size() for s2, q in zip(subs, ops)
                       if q.placements[m].is_shard() and s2[q.placements[m].dim] != c)
            if c not in out:
                cost += 2 * out_bytes
            if best_cost is None or cost < best_cost:
                best, best_cost = c, cost
        split = _size(mesh, [i for i, c in enumerate(keep) if c == best]) * mesh.size(m)
        keep.append(best if best is None or size[best] % split == 0 else None)
    return keep


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` for equations of explicit letters; on DTensors it
    runs sharded by the letters (module docstring)."""
    mesh = mesh_of(*ops)
    if mesh is None:
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lhs, out = eq.replace(" ", "").split("->")
    subs = lhs.split(",")
    ops = [reduced(as_dtensor(mesh, o)) for o in ops]
    keep = _plan(subs, out, ops, mesh)
    split = {m for m, c in enumerate(keep) if c is not None}
    local = []
    for o, sub in zip(ops, subs):
        want = [Shard(sub.index(c)) if c is not None and c in sub else Replicate() for c in keep]
        if list(o.placements) != want:
            o = o.redistribute(mesh, want)
        local.append(_local(o, split))
    y = torch.einsum(eq, *local)
    place = [Replicate() if c is None else Shard(out.index(c)) if c in out else Partial()
             for c in keep]
    return reduced(DTensor.from_local(y, mesh, place, run_check=False))


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """F.embedding(tokens, table); on a mesh the rows follow the tokens'
    batch layout, the table is gathered over every other mesh dim but the
    one that splits its vocabulary, and there each rank looks up the
    tokens its rows hold (a partial sum, zero elsewhere), as a
    vocab-parallel embedding does."""
    import torch.nn.functional as F
    mesh = mesh_of(tokens, table)
    if mesh is None:
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    tokens, table = reduced(as_dtensor(mesh, tokens)), reduced(table)
    vocab = [m for m, p in enumerate(table.placements)
             if p.is_shard() and p.dim == 0 and not tokens.placements[m].is_shard()]
    tpl = [Shard(0) if m in vocab else Replicate() for m in range(mesh.ndim)]
    if list(table.placements) != tpl:
        table = table.redistribute(mesh, tpl)
    tok = tokens.to_local()
    # the table's rows gather the gradient of this rank's tokens only
    tab = _local(table, {m for m, p in enumerate(tokens.placements) if p.is_shard()})
    if vocab:
        v0 = _vocab_start(mesh, vocab, tab.shape[0])
        hit = (tok >= v0) & (tok < v0 + tab.shape[0])
        y = F.embedding(torch.where(hit, tok - v0, 0), tab)
        y = torch.where(hit[..., None], y, 0)
    else:
        y = F.embedding(tok, tab)
    place = [Partial() if m in vocab else tokens.placements[m] for m in range(mesh.ndim)]
    return reduced(DTensor.from_local(y, mesh, place, run_check=False))


def _placements(mesh, dims, batch: bool, heads: bool):
    """Placements of a tensor whose batch dim is dims[0] and head dim
    dims[1] (None for neither): the batch over the data axes when `batch`,
    the heads over "model" when `heads`."""
    from torch.distributed.tensor import Replicate, Shard
    b, h = dims
    out = [Replicate()] * mesh.ndim
    if batch and b is not None:
        for m in data_dims(mesh):
            out[m] = Shard(b)
    md = model_dim(mesh)
    if heads and h is not None and md is not None:
        out[md] = Shard(h)
    return out


def shards(mesh, size: int, dims) -> bool:
    """Whether a dim of `size` splits evenly over the mesh dims `dims`. A
    dim of one is left whole: split over mesh dims of size 1 it would hold
    the same values, but a gradient that keeps such a split where the
    forward broadcast the dim cannot be squeezed back (a batch of one)."""
    n = _size(mesh, dims)
    return n > 0 and size > 1 and size % n == 0


def local_map(fn: Callable, args: Sequence[Any], dims: Sequence[Any], out_dims: Any, mesh, *,
              batch: bool, heads: bool) -> Any:
    """fn(*local args) on each rank, its inputs laid out by their roles.

    `dims[i]` is (batch dim, head dim) of args[i] (either None), or None
    for an argument passed as it is; `out_dims` is one such pair for a
    tensor result or a tuple of pairs for a tuple. `batch` and `heads` say
    whether the batch is split over the data axes and the heads over
    "model" (the caller checks that they divide). The results are DTensors
    of those layouts."""
    from torch.distributed.tensor import DTensor

    split = set(data_dims(mesh)) if batch else set()
    md = model_dim(mesh)
    if heads and md is not None:
        split.add(md)
    local = []
    for a, d in zip(args, dims):
        if d is None or a is None:
            local.append(a)
            continue
        want = _placements(mesh, d, batch, heads)
        a = reduced(as_dtensor(mesh, a))
        if list(a.placements) != want:
            a = a.redistribute(mesh, want)
        local.append(_local(a, split))
    res = fn(*local)

    def wrap(t, d):
        return DTensor.from_local(t, mesh, _placements(mesh, d, batch, heads), run_check=False)
    if isinstance(out_dims, list) or (isinstance(out_dims, tuple) and out_dims
                                      and isinstance(out_dims[0], tuple)):
        return tuple(wrap(t, d) for t, d in zip(res, out_dims))
    return wrap(res, out_dims)


def on_heads(fn: Callable, args: Sequence[Any], dims: Sequence[Any], out_dims: Any,
             n_heads: int) -> Any:
    """fn(*args) as it stands off a mesh; on a mesh `local_map` with the
    batch (args[0]'s dim 0) split over the data axes where they divide it
    and the heads over "model" where it divides `n_heads`: how the SSD
    scans and steps and the sLSTM's loop reach plain tensors."""
    mesh = mesh_of(*args)
    if mesh is None:
        return fn(*args)
    md = model_dim(mesh)
    heads = md is not None and n_heads % mesh.size(md) == 0
    batch = shards(mesh, args[0].shape[0], data_dims(mesh))
    return local_map(fn, args, dims, out_dims, mesh, batch=batch, heads=heads)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp over the last dim, the logit at each label clamped to 0)
    of f32 `logits` (..., V) and int64 `labels` (...).

    Off a mesh, or where no mesh dim splits the vocabulary, that is
    ``torch.logsumexp`` and ``torch.gather`` on each rank's rows, so the
    1x1 mesh equals the unmeshed loss bit for bit. Where the vocabulary
    is split, no rank holds a whole row: each takes its block's max, the
    max over the vocabulary group stabilizes the sum of exp, which is
    summed over the group, and the gold logit comes from the rank whose
    block holds the label (a partial sum, zero elsewhere)."""
    mesh = mesh_of(logits, labels)
    if mesh is None:
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0])
    from torch.distributed.tensor import DTensor, Partial, Replicate

    v = logits.dim() - 1
    logits = reduced(as_dtensor(mesh, logits))
    vocab = [m for m, p in enumerate(logits.placements) if p.is_shard() and p.dim == v]
    # each row's placements: the logits' with the vocab dim dropped
    row = [Replicate() if m in vocab else p for m, p in enumerate(logits.placements)]
    labels = reduced(as_dtensor(mesh, labels))
    if list(labels.placements) != row:
        labels = labels.redistribute(mesh, row)
    lab = labels.to_local().clamp(min=0)
    lg = logits.to_local()
    if _size(mesh, vocab) == 1:
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, lab[..., None])[..., 0]
        return (DTensor.from_local(lse, mesh, row, run_check=False),
                DTensor.from_local(gold, mesh, row, run_check=False))
    part = [Partial("max") if m in vocab else p for m, p in enumerate(row)]
    top = reduced(DTensor.from_local(lg.detach().amax(dim=-1), mesh, part, run_check=False))
    top = top.to_local()
    # a row of -inf logits keeps its max out of the exponent
    top = torch.where(torch.isfinite(top), top, 0.0)
    sums = [Partial() if m in vocab else p for m, p in enumerate(row)]
    s = reduced(DTensor.from_local(torch.sum(torch.exp(lg - top[..., None]), dim=-1), mesh,
                                   sums, run_check=False))
    lse = torch.log(s) + DTensor.from_local(top, mesh, row, run_check=False)
    v0 = _vocab_start(mesh, vocab, lg.shape[-1])
    hit = (lab >= v0) & (lab < v0 + lg.shape[-1])
    g = torch.gather(lg, -1, torch.where(hit, lab - v0, 0)[..., None])[..., 0]
    gold = reduced(DTensor.from_local(torch.where(hit, g, 0.0), mesh, sums, run_check=False))
    return lse, gold


def _vocab_start(mesh, vocab, block: int) -> int:
    """The first vocabulary index of this rank's block of `block` entries
    along the mesh dims `vocab` (outer to inner)."""
    v0 = 0
    for m in vocab:
        v0 = v0 * mesh.size(m) + mesh.get_local_rank(m)
    return v0 * block


def write_slot(cache: torch.Tensor, dim: int, slot: int, value: torch.Tensor) -> None:
    """cache.select(dim, slot).copy_(value), IN PLACE, on a cache that may
    be a DTensor: the value is laid out as the cache is on its other dims
    and only the rank that holds `slot` of a sharded `dim` writes it, into
    its own piece, so the cache is never gathered."""
    if not is_dtensor(cache):
        cache.select(dim, slot).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    # the value's placements: the cache's, with `dim` dropped (replicated)
    want, along = [], []
    for m, p in enumerate(cache.placements):
        if p.is_shard() and p.dim == dim:
            want.append(Replicate())
            along.append(m)
        elif p.is_shard():
            want.append(Shard(p.dim - (p.dim > dim)))
        else:
            want.append(Replicate())
    v = reduced(as_dtensor(mesh, value))
    if list(v.placements) != want:
        v = v.redistribute(mesh, want)
    local = cache.to_local()
    piece = local.shape[dim]
    owner, coord = slot // piece, 0
    for m in along:                              # this rank's block along `dim`
        coord = coord * mesh.size(m) + mesh.get_local_rank(m)
    if coord == owner:
        local.select(dim, slot - owner * piece).copy_(v.to_local())
