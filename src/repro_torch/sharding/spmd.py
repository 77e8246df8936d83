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

A mesh dim of size 1 splits nothing, so on the 1x1 mesh every local piece
is the whole tensor and every collective acts on a group of one.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

__all__ = ["as_dtensor", "data_dims", "einsum", "embedding", "is_dtensor", "local_map",
           "mesh_of", "model_dim", "on_heads", "reduced", "replicating", "shards", "write_slot"]


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
    on every rank, so that is what they are."""
    import contextlib
    if mesh_of(*ts) is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


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
    local = []
    for o, sub in zip(ops, subs):
        want = [Shard(sub.index(c)) if c is not None and c in sub else Replicate() for c in keep]
        if list(o.placements) != want:
            o = o.redistribute(mesh, want)
        local.append(o.to_local())
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
    tok, tab = tokens.to_local(), table.to_local()
    if vocab:
        v0 = 0
        for m in vocab:
            v0 = v0 * mesh.size(m) + mesh.get_local_rank(m)
        v0 *= tab.shape[0]
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
    """Whether a dim of `size` splits evenly over the mesh dims `dims`."""
    n = _size(mesh, dims)
    return n > 0 and size % n == 0


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

    local = []
    for a, d in zip(args, dims):
        if d is None or a is None:
            local.append(a)
            continue
        want = _placements(mesh, d, batch, heads)
        a = reduced(as_dtensor(mesh, a))
        if list(a.placements) != want:
            a = a.redistribute(mesh, want)
        local.append(a.to_local())
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
