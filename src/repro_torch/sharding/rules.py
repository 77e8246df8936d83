"""Path-based sharding rules: param/batch/cache trees -> PartitionSpec.

Counterpart of ``repro/sharding/rules.py``, rule for rule. Strategy
(single-pod mesh (data=16, model=16); multi-pod adds pod=2):

  * weights: FSDP over 'data' on the d_model-like axis, TP over 'model' on
    heads / d_ff / experts / vocab; replicated across 'pod'.
  * activations/batch: batch dim over ('pod', 'data'); a batch of one
    shards the KV-cache/sequence axis over ('pod', 'data') instead.
  * every rule degrades to None when the dim is not divisible by the axis
    size (e.g. MQA kv=1 -> shard head_dim instead of kv heads).

The rules are pure functions of a mesh SHAPE (its axis names and sizes):
`MeshShape((16, 16), ("data", "model"))` evaluates them at the production
shape without 256 ranks, and a live `torch.distributed.device_mesh.
DeviceMesh` (from `repro_torch.launch.mesh`) is read the same way.
`PartitionSpec` is the port's own: a tuple of None, an axis name or a
tuple of names per dim, normalized as jax's (a one-name tuple becomes the
name), so it equals the reference's spec entry for entry. `named` and
`FlatShardings` pair a spec with the live mesh; the flat engine's block
layout is computed from them in `repro_torch.sharding.flat`.

The model zoo's trees go onto a live mesh as DTensors: `placements` turns
a spec into DTensor placements and `distribute` places a whole tree, real
tensors by scattering them and meta stand-ins as each rank's meta shard
(no collective), so a step can be traced in a fake world.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree_util import _LEAF, _flatten_into, tree_map, tree_unflatten


class MeshShape:
    """A mesh's axis names and sizes, in mesh order (what the rules read).

    `shape[name]` is an axis size, as on a jax Mesh."""

    def __init__(self, sizes, names):
        sizes, names = tuple(int(s) for s in sizes), tuple(str(n) for n in names)
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} axis names")
        self.axis_names = names
        self.sizes = sizes
        self.shape = dict(zip(names, sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def __eq__(self, other) -> bool:
        return (isinstance(other, MeshShape) and self.axis_names == other.axis_names
                and self.sizes == other.sizes)

    def __hash__(self) -> int:
        return hash((self.axis_names, self.sizes))

    def __repr__(self) -> str:
        return f"MeshShape({self.sizes}, {self.axis_names})"


def mesh_shape(mesh) -> MeshShape:
    """The MeshShape of a MeshShape, a torch DeviceMesh (mesh_dim_names and
    shape) or anything with jax's `axis_names` and `shape` mapping."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshShape(tuple(mesh.mesh.shape), names)
    if hasattr(mesh, "axis_names") and hasattr(mesh, "shape"):
        return MeshShape(tuple(mesh.shape[a] for a in mesh.axis_names), mesh.axis_names)
    raise TypeError(f"not a mesh: {mesh!r} (a MeshShape, a named DeviceMesh or a jax mesh)")


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if len(e) == 1:
            return e[0]
    return e


class PartitionSpec(tuple):
    """A spec entry per dim: None (replicated), an axis name, or a tuple of
    axis names (major to minor). A one-name tuple is stored as the name,
    as jax's PartitionSpec stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def data_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_shape(mesh).axis_names else ("data",)


def axis_size(mesh, name) -> int:
    ms = mesh_shape(mesh)
    if isinstance(name, (tuple, list)):
        return math.prod(axis_size(ms, a) for a in name)
    return ms.shape[name] if name in ms.axis_names else 1


def _div(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _maybe(mesh, axis, dim: int):
    return axis if _div(dim, axis_size(mesh, axis)) else None


def spec_for_param(path_tokens: Tuple[str, ...], shape: Tuple[int, ...], cfg, mesh
                   ) -> PartitionSpec:
    """The spec of one parameter from its path tokens and shape (`cfg` is
    the ModelConfig, unread by the rules as in the reference)."""
    t = set(path_tokens)
    last = path_tokens[-1] if path_tokens else ""
    M, D = "model", "data"
    ms = axis_size(mesh, M)

    if len(shape) <= 1:
        return P()  # norms, scalar gate params: replicate

    # embeddings
    if last == "embed":
        return P(_maybe(mesh, M, shape[0]), _maybe(mesh, D, shape[1]))
    if last == "unembed":
        return P(_maybe(mesh, D, shape[0]), _maybe(mesh, M, shape[1]))
    if last in ("patch_proj",):
        return P(_maybe(mesh, D, shape[0]), _maybe(mesh, M, shape[1]))
    if last == "enc_pos":
        return P(None, None)

    # attention
    if "attn" in t or "self" in t or "cross" in t or last == "shared_attn" \
            or any(x in ("attn", "self", "cross", "shared_attn") for x in path_tokens):
        if last == "wq":
            return P(_maybe(mesh, D, shape[0]), _maybe(mesh, M, shape[1]), None)
        if last in ("wk", "wv"):
            if _div(shape[1], ms):
                return P(_maybe(mesh, D, shape[0]), M, None)
            return P(_maybe(mesh, D, shape[0]), None, _maybe(mesh, M, shape[2]))
        if last == "wo":
            return P(_maybe(mesh, M, shape[0]), None, _maybe(mesh, D, shape[2]))
        if last == "bq":
            return P(_maybe(mesh, M, shape[0]), None)
        if last in ("bk", "bv"):
            if _div(shape[0], ms):
                return P(M, None)
            return P(None, _maybe(mesh, M, shape[1]))

    # MoE
    if last == "router":
        return P(_maybe(mesh, D, shape[0]), None)
    if last in ("w_gate", "w_up") and len(shape) == 3:   # (E, d, f)
        if _div(shape[0], ms):
            return P(M, _maybe(mesh, D, shape[1]), None)
        return P(None, _maybe(mesh, D, shape[1]), _maybe(mesh, M, shape[2]))
    if last == "w_down" and len(shape) == 3:             # (E, f, d)
        if _div(shape[0], ms):
            return P(M, None, _maybe(mesh, D, shape[2]))
        return P(None, _maybe(mesh, M, shape[1]), _maybe(mesh, D, shape[2]))

    # dense MLP
    if last in ("w_gate", "w_up"):                       # (d, f)
        return P(_maybe(mesh, D, shape[0]), _maybe(mesh, M, shape[1]))
    if last == "w_down":                                 # (f, d)
        return P(_maybe(mesh, M, shape[0]), _maybe(mesh, D, shape[1]))

    # Mamba2
    if last in ("w_z", "w_x"):                           # (d, d_in)
        return P(_maybe(mesh, D, shape[0]), _maybe(mesh, M, shape[1]))
    if last in ("w_B", "w_C", "w_dt"):                   # (d, N|H)
        return P(_maybe(mesh, D, shape[0]), None)
    if last == "conv":
        return P(None, None)
    if last == "w_out":                                  # (d_in, d)
        return P(_maybe(mesh, M, shape[0]), _maybe(mesh, D, shape[1]))

    # xLSTM
    if last in ("w_q", "w_k", "w_v") and len(shape) == 3:  # (dm, H, N)
        return P(_maybe(mesh, M, shape[0]), None, None)
    if last in ("w_i", "w_f"):                           # (dm, H)
        return P(_maybe(mesh, M, shape[0]), None)
    if last == "w_in" and len(shape) == 4:               # (d, H, hd, 4)
        return P(_maybe(mesh, D, shape[0]), None, None, None)
    if last == "r":                                      # (H, hd, hd, 4)
        return P(None, None, None, None)

    # generic 2D fallback: FSDP x TP
    if len(shape) == 2:
        return P(_maybe(mesh, D, shape[0]), _maybe(mesh, M, shape[1]))
    return P(*([None] * len(shape)))


def _map_with_path(fn, tree) -> Any:
    """tree_map with the leaf's path tokens as jax spells them (dict key,
    NamedTuple field name, sequence index), in jax's leaf order."""
    leaves = []
    treedef = _flatten_into(tree, leaves)
    out = []

    def walk(node, path):
        if node is None:
            return
        if node == _LEAF:
            out.append(fn(path, leaves[len(out)]))
            return
        kind, aux, children = node
        if kind == "dict":
            names = [str(k) for k in aux]
        elif kind == "namedtuple":
            names = list(aux._fields)
        else:
            names = [str(i) for i in range(len(children))]
        for name, child in zip(names, children):
            walk(child, path + (name,))

    walk(treedef, ())
    return tree_unflatten(treedef, out)


def param_specs(params: Any, cfg, mesh, bank_axis: bool = False,
                node_axes: bool = False) -> Any:
    """PartitionSpec tree for params (or the owner bank if bank_axis: a
    leading owner axis, replicated; or a pytree state's noise trees if
    node_axes: leading owner and level axes, both replicated): the stacked
    layer axis of a scan-family block (a leading L dim under
    "blocks"/"enc_blocks" with no numeric index in the path) is stripped
    and replicated."""
    lead = 2 if node_axes else 1 if bank_axis else 0

    def g(toks, leaf):
        shape = tuple(leaf.shape)
        core = shape[lead:]
        is_list_block = any(t.isdigit() for t in toks)
        if ("blocks" in toks or "enc_blocks" in toks) and not is_list_block:
            spec = P(None, *spec_for_param(toks, core[1:], cfg, mesh))
        else:
            spec = spec_for_param(toks, core, cfg, mesh)
        return P(*([None] * lead), *spec)
    return _map_with_path(g, params)


def batch_specs(batch: Any, shape_cfg, mesh, microbatches: int = 0) -> Any:
    """tokens/labels (B, S) or microbatch-major (G, m, S); patches/frames
    get one extra trailing dim."""
    B = shape_cfg.global_batch
    da = data_axes(mesh)
    rows = B // microbatches if microbatches else B
    bshard = da if _div(rows, axis_size(mesh, da)) else None

    def f(toks, leaf):
        nd = len(leaf.shape)
        if microbatches:                       # (G, m, ...)
            return P(*((None, bshard) + (None,) * (nd - 2)))
        return P(*((bshard,) + (None,) * (nd - 1)))

    return _map_with_path(f, batch)


def cache_specs(cache: Any, cfg, mesh, batch: int) -> Any:
    """KV caches (L, B, C, Kv, hd) / states. B == 1 -> shard the cache's
    sequence axis."""
    da = data_axes(mesh)
    ds = axis_size(mesh, da)
    ms = axis_size(mesh, "model")
    bshard = da if _div(batch, ds) else None

    def f(toks, leaf):
        s = tuple(leaf.shape)
        if "kv" in toks or "cross" in toks or "shared" in toks:
            # (L, B, C, Kv, hd) stacked or (B, C, Kv, hd) per layer
            off = 1 if len(s) == 5 else 0
            Bc, C, Kv, hd = s[off:]
            kv_ax = "model" if _div(Kv, ms) else None
            hd_ax = None if kv_ax else ("model" if _div(hd, ms) else None)
            if bshard is not None:
                spec = (bshard, None, kv_ax, hd_ax)
            else:
                spec = (None, da if _div(C, ds) else None, kv_ax, hd_ax)
            return P(*((None,) * off + spec))
        if "mamba" in toks:                      # h (B, H, N, P) / conv (B, K, C)
            if len(s) == 4:
                return P(bshard, "model" if _div(s[1], ms) else None, None, None)
            return P(bshard, None, "model" if _div(s[2], ms) else None)
        if "states" in toks:                     # xlstm states
            return P(*((bshard,) + (None,) * (len(s) - 1)))
        return P(*([None] * len(s)))

    return _map_with_path(f, cache)


class NamedSharding(NamedTuple):
    """A spec on a mesh: the live DeviceMesh (or a MeshShape) and the
    PartitionSpec."""
    mesh: Any
    spec: PartitionSpec


def named(mesh, spec_tree: Any) -> Any:
    """NamedSharding(mesh, spec) for every spec of a spec tree (a spec
    alone, or a dict / list / tuple of them)."""
    if isinstance(spec_tree, PartitionSpec):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(named(mesh, v) for v in spec_tree))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(named(mesh, v) for v in spec_tree)
    if spec_tree is None:
        return None
    raise TypeError(f"not a spec tree: {spec_tree!r}")


def placements(spec: PartitionSpec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of `spec` on a live DeviceMesh: a tensor dim
    mapped to an axis gives Shard(dim) on that mesh dim; a dim mapped to a
    tuple of axes gives Shard(dim) on each, whose order must be the mesh's
    (jax's major to minor is DTensor's outer to inner split); every other
    mesh dim is Replicate()."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims of {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def _local_shape(shape, place, mesh) -> Tuple[int, ...]:
    sizes = list(shape)
    for p, n in zip(place, mesh.mesh.shape):
        if p.is_shard():
            if sizes[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide over {n}")
            sizes[p.dim] //= n
    return tuple(sizes)


def distribute_leaf(t, spec: PartitionSpec, mesh):
    """One tensor placed by `spec`: `distribute_tensor` for a real tensor
    (every rank passes the same values); a meta tensor becomes a DTensor
    over this rank's meta shard, made by `DTensor.from_local` without a
    check, so nothing communicates. A DTensor, or anything that is not a
    tensor (a decode position), is returned as it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
        return t
    place = placements(spec, mesh)
    if t.device.type == "meta":
        local = torch.empty(_local_shape(t.shape, place, mesh), dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, place, run_check=False, shape=t.shape,
                                  stride=t.stride())
    return distribute_tensor(t, mesh, place)


def distribute(tree: Any, spec_tree: Any, mesh=None) -> Any:
    """Every tensor of `tree` placed by the spec at its place in
    `spec_tree`: a tree of `param_specs`, `batch_specs` or `cache_specs`
    on `mesh`, or a NamedSharding tree of `named` (which carries its
    mesh)."""
    it = iter(_spec_leaves(spec_tree))

    def one(t):
        s = next(it)
        if isinstance(s, NamedSharding):
            return distribute_leaf(t, s.spec, s.mesh)
        return distribute_leaf(t, s, mesh)
    return tree_map(one, tree)


def distribute_blocks(tree: Any, spec_tree: Any, mesh, lead: int,
                      to_tensor: Callable[[Any], torch.Tensor]) -> Any:
    """Every host array of `tree` (numpy, or a CPU tensor) as a DTensor
    laid out by its spec in `spec_tree` (a `param_specs` tree of the
    params) with `lead` replicated axes in front (1: an owner bank, 2: a
    pytree state's noise trees, as `param_specs(..., bank_axis=True)` and
    `(..., node_axes=True)` lay them out). Each rank slices its own block
    on the host and hands only that to `to_tensor` (which puts it on the
    device), so nothing communicates and no rank holds a whole leaf."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.sharding.spmd import contiguous_stride
    it = iter(_spec_leaves(spec_tree))

    def one(a):
        s = next(it)
        shape = tuple(a.shape)
        place = placements(P(*([None] * lead), *s), mesh)
        size, off = compute_local_shape_and_global_offset(shape, mesh, place)
        block = a[tuple(slice(int(o), int(o) + int(n)) for o, n in zip(off, size))]
        return DTensor.from_local(to_tensor(block), mesh, place, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))
    return tree_map(one, tree)


def _spec_leaves(spec_tree: Any) -> list:
    """The specs (or NamedShardings) of a spec tree in jax's leaf order."""
    out: list = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, (NamedSharding, PartitionSpec)):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            raise TypeError(f"not a spec tree: {node!r}")
    walk(spec_tree)
    return out


# ------------------- flat federation state (owner bank) ---------------------
# The flat engine's state is two buffers: theta_L (P,) and the owner bank
# (N_owners, P), the algorithm's dominant memory (N model copies). The bank
# is the natural FSDP target: the owner axis N is the engine's data-parallel
# dimension (rounds touch one row each), so it shards over the data axes; P
# shards like the model over 'model'. When N does not divide the data axes
# (small federations on big meshes) the data axes fold into P instead, so
# the bank bytes still spread over every rank. theta_L and a gathered bank
# row always share the bank's P-axis layout, so the round's elementwise ops
# (theta_bar, eqs. 5/7) stay local. Every rule degrades to replication when
# the dim does not divide.


class FlatShardings(NamedTuple):
    """The flat engine's layout, one NamedSharding per state buffer.

    Quantized banks reuse the bundle: `bank` lays out the (N, P) codes,
    `bank_scales` the (N, nb) scales (owner rows over the data axes, the
    scale axis replicated) and `row` the shared (P,) error-feedback
    residual, which lives exactly where theta lives."""
    theta: NamedSharding        # theta_L (P,)
    bank: NamedSharding         # owner bank (N_owners, P), codes if quantized
    row: NamedSharding          # one gathered bank row / the EF residual (P,)
    ledger: NamedSharding       # (N,) int32 counters: replicated
    bank_scales: NamedSharding = None   # quantized-bank scales (N_owners, nb)
    # DP-FTRL node buffer (N_owners, depth, P): the bank's layout with a
    # replicated depth axis in between
    tree_nodes: NamedSharding = None
    # the fault layer's (N,) counters: replicated like the ledger
    faults: NamedSharding = None


def flat_axes(mesh, n_owners: int, p: int
              ) -> Tuple[Optional[Tuple[str, ...]], Optional[Tuple[str, ...]]]:
    """(owner-axis, P-axis) mesh axes of the (N_owners, P) bank."""
    da = data_axes(mesh)
    ds, ms = axis_size(mesh, da), axis_size(mesh, "model")
    n_ax = tuple(da) if (ds > 1 and _div(n_owners, ds)) else None
    p_axes = ["model"] if (ms > 1 and _div(p, ms)) else []
    if n_ax is None and ds > 1 and _div(p, ds * (ms if p_axes else 1)):
        p_axes.extend(da)
    return n_ax, (tuple(p_axes) if p_axes else None)


def flat_theta_spec(mesh, n_owners: int, p: int) -> PartitionSpec:
    return P(flat_axes(mesh, n_owners, p)[1])


def flat_bank_spec(mesh, n_owners: int, p: int) -> PartitionSpec:
    n_ax, p_ax = flat_axes(mesh, n_owners, p)
    return P(n_ax, p_ax)


def flat_shardings(mesh, n_owners: int, p: int) -> FlatShardings:
    """The flat engine's layout bundle, degraded to what divides."""
    n_ax, p_ax = flat_axes(mesh, n_owners, p)
    return FlatShardings(theta=NamedSharding(mesh, P(p_ax)),
                         bank=NamedSharding(mesh, P(n_ax, p_ax)),
                         row=NamedSharding(mesh, P(p_ax)),
                         ledger=NamedSharding(mesh, P()),
                         bank_scales=NamedSharding(mesh, P(n_ax)),
                         tree_nodes=NamedSharding(mesh, P(n_ax, None, p_ax)),
                         faults=NamedSharding(mesh, P()))


def paged_shardings(mesh, n_hot: int, p: int) -> FlatShardings:
    """The layout of a PAGED flat state: hot rows shard exactly like bank
    rows, `n_hot` standing in for N (as do the paged tree nodes, (n_hot,
    depth, P)); the (N,) counter columns and the (n_hot,) page table stay
    replicated. Pick an n_hot that the data-axis size divides to keep the
    rows spread."""
    return flat_shardings(mesh, n_hot, p)
