"""Per-device cost of a torch step: FLOPs, traffic and collective bytes.

The counterpart of ``repro/analysis/hlo_cost.py``. The reference walks the
post-optimization HLO of the SPMD-partitioned module, whose shapes are one
device's; here a TorchDispatchMode sees every aten op that runs, and on a
mesh it sees the ops on each rank's LOCAL tensors:

    with OpCost() as cost:
        out = bundle.step(*bundle.args)
    cost.summary()      # {"flops", "traffic_bytes", "collective_bytes_total", ...}
    cost.save("x.trace.json.zst")            # the trace, for `reanalyze`

A DTensor op reaches the mode first with DTensor arguments; the mode
returns NotImplemented, so DTensor's own dispatch runs the op as local
ops and collectives (``_c10d_functional``), and the mode counts those.
So what is counted is one rank's share, as the walker counts one device.
The fake tensors that DTensor's sharding propagation runs ops on count
nothing.

    flops            2 M N K for every mm, bmm, addmm and baddbmm (what
                     einsum lowers to), the convolutions, and the custom
                     ops' registered formulas (the flash and SSD kernels:
                     ``torch.utils.flop_counter.register_flop_formula``);
                     element-wise flops are ignored, as the walker does.
    traffic_bytes    the bytes of every op's tensor inputs and outputs (an
                     output that aliases an input counted once), views
                     and metadata ops left out. Eager torch fuses nothing,
                     so this is the unfused traffic: the walker's is after
                     XLA's fusion.
    collective_bytes the operand bytes of each kind, as the walker's keys:
                     all-gather, reduce-scatter, all-reduce, all-to-all and
                     send/recv as collective-permute; 0 on a group of one
                     rank, which XLA drops.

The mode also tracks the bytes that the ops' outputs keep alive, and their
peak (`peak_live_bytes`): the step's transient memory on one device.

The trace is a count of distinct events (op, argument shapes and dtypes,
result shapes, a collective's group size), so a loop of ten thousand
identical steps is one line; `cost_of(events)` is the cost model over it,
and ``analysis.reanalyze`` reruns it on saved traces when it changes.
"""
from __future__ import annotations

import collections
import json
import weakref
from typing import Any, Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective ops by name -> (the walker's kind, the operand's argument
# index); the operand bytes are that argument's (every tensor of it, for the
# c10d list forms). A receive is the other end of a send, counted there.
_COLL = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "c10d.recv_": ("collective-permute", None),
}
_METADATA = frozenset({
    "aten.detach", "aten.alias", "aten.lift_fresh", "aten.empty", "aten.empty_strided",
    "aten.empty_like", "aten.new_empty", "aten.new_empty_strided", "aten._local_scalar_dense",
    "aten.is_same_size", "aten.sym_size", "aten.sym_stride", "aten.sym_numel",
    "aten.sym_storage_offset", "aten.set_", "aten.resize_",
    "_c10d_functional.wait_tensor", "c10d.barrier",
})


def _sig(x) -> Any:
    """A hashable, JSON-able signature of an argument: a tensor as ("T",
    shape, dtype), sequences elementwise, anything else by value or str."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(int(s) for s in x.shape), str(x.dtype).replace("torch.", ""))
    if isinstance(x, (list, tuple)):
        return ("L",) + tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return ("D",) + tuple((k, _sig(v)) for k, v in sorted(x.items()))
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return str(x)


def _group_size(func, args, kwargs) -> int:
    """The number of ranks a collective op runs over: its `group_size`
    argument, else the size of its group (named, or the ProcessGroup)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    named = {a.name: v for a, v in zip(func._schema.arguments, args)}
    named.update(kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    if "group_name" in named:
        return int(_resolve_process_group(named["group_name"]).size())
    for v in named.values():
        if isinstance(v, torch.ScriptObject):          # a boxed ProcessGroup
            return int(torch.distributed.ProcessGroup.unbox(v).size())
    raise ValueError(f"no process group among the arguments of {func}")


def _op_name(func) -> str:
    return f"{func.namespace}.{func._schema.name.split('::')[-1]}"


class OpCost(TorchDispatchMode):
    """A dispatch mode that counts the cost of every op it sees (module
    docstring); `events` maps each distinct event to its count."""

    def __init__(self):
        super().__init__()
        self.events: collections.Counter = collections.Counter()
        self.live = 0
        self.peak_live_bytes = 0
        self._held: Dict[int, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor runs it as local ops, seen here
        if any(t is not torch.Tensor and t is not torch.nn.Parameter for t in types):
            return func(*args, **kwargs)     # the fake tensors of DTensor's propagation
        out = func(*args, **kwargs)
        name = _op_name(func)
        extra = _group_size(func, args, kwargs) if name in _COLL else None
        self.events[(name, str(func._overloadname), _sig(args), _sig(kwargs), _sig(out),
                     extra)] += 1
        if name not in _METADATA:
            self._hold(out)
        return out

    def _hold(self, out) -> None:
        """Count the storage of each output tensor as live until every
        tensor of this trace that uses it is gone."""
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            held = self._held.get(key)
            if held is None:
                held = self._held[key] = [0, st.nbytes()]
                self.live += held[1]
                self.peak_live_bytes = max(self.peak_live_bytes, self.live)
            held[0] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        held = self._held.get(key)
        if held is not None:
            held[0] -= 1
            if held[0] == 0:
                self.live -= held[1]
                del self._held[key]

    def summary(self) -> Dict[str, float]:
        return cost_of(self.events.items())

    def save(self, path: str) -> None:
        """The trace as zstd-compressed JSON (one [event, count] a line)."""
        save_trace(path, self.events.items(), peak_live_bytes=self.peak_live_bytes)


def save_trace(path: str, events: Iterable[Tuple[Any, int]], **meta) -> None:
    import zstandard
    doc = {"version": 1, **meta, "events": [[list(e), n] for e, n in events]}
    with open(path, "wb") as f:
        f.write(zstandard.ZstdCompressor(level=6).compress(json.dumps(doc).encode()))


def load_trace(path: str) -> Dict[str, Any]:
    import zstandard
    with open(path, "rb") as f:
        doc = json.loads(zstandard.ZstdDecompressor().decompress(f.read()))
    doc["events"] = [(_tuples(e), n) for e, n in doc["events"]]
    return doc


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def _tensors(sig):
    """The ("T", shape, dtype) nodes of a signature."""
    if isinstance(sig, tuple) and sig:
        if sig[0] == "T":
            yield sig
        elif sig[0] in ("L", "D"):
            for v in sig[1:]:
                yield from _tensors(v[1] if sig[0] == "D" else v)


def _nbytes(t) -> int:
    n = 1
    for s in t[1]:
        n *= s
    return n * getattr(torch, t[2]).itemsize


def _shapes(sig):
    """The signature as a flop formula reads it: tensors as their shapes."""
    if isinstance(sig, tuple) and sig:
        if sig[0] == "T":
            return torch.Size(sig[1])
        if sig[0] == "L":
            return tuple(_shapes(v) for v in sig[1:])
        if sig[0] == "D":
            return {k: _shapes(v) for k, v in sig[1:]}
    return sig


def _packet(name: str):
    ns, op = name.split(".", 1)
    return getattr(getattr(torch.ops, ns), op)


def product_dtype(event) -> str:
    """The dtype whose peak an event's flops run at: the operands' for a
    library product; f32 for the port's kernels (f32 FMAs, no tensor
    cores, whatever they read)."""
    if event[0].startswith("repro_torch."):
        return "float32"
    first = next(iter(_tensors(event[2])), None)
    return first[2] if first is not None else "float32"


def event_cost(event) -> Tuple[float, float, str, float]:
    """(flops, traffic bytes, collective kind or "", collective bytes) of
    one event."""
    from torch.utils.flop_counter import flop_registry

    # ops a saved trace may name: the kernels' custom ops (their formulas are
    # registered beside them) and the functional collectives' own ops
    import torch.distributed._functional_collectives  # noqa: F401

    import repro_torch.kernels.flash_attention.kernel  # noqa: F401
    import repro_torch.kernels.ssm_scan.kernel  # noqa: F401

    name, overload, args, kwargs, out, extra = event
    if name in _METADATA:
        return 0.0, 0.0, "", 0.0
    packet = _packet(name)
    func = getattr(packet, overload)
    if func.is_view:
        return 0.0, 0.0, "", 0.0
    flops = 0.0
    if packet in flop_registry:
        flops = float(flop_registry[packet](*_shapes(args), **_shapes(kwargs),
                                            out_val=_shapes(out)))
    ins = list(_tensors(args)) + list(_tensors(kwargs))
    outs = list(_tensors(out))
    aliased = sum(r.alias_info is not None for r in func._schema.returns)
    traffic = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs[aliased:]))
    kind, coll = "", 0.0
    if name in _COLL:
        kind, idx = _COLL[name]
        if idx is not None and extra and extra > 1:
            coll = float(sum(_nbytes(t) for t in _tensors(args[1 + idx])))
    return flops, traffic, kind, coll


def cost_of(events: Iterable[Tuple[Any, int]]) -> Dict[str, float]:
    """The walker's keys over a trace: flops, traffic_bytes,
    collective_bytes_total and collective_<kind> per device; and
    flops_<dtype>, the flops by the dtype of their products (the roofline
    takes each at its own peak)."""
    flops = traffic = 0.0
    coll = {k: 0.0 for k in COLLECTIVES}
    by_dtype: Dict[str, float] = collections.defaultdict(float)
    for event, n in events:
        f, t, kind, c = event_cost(event)
        flops += n * f
        traffic += n * t
        if f:
            by_dtype[product_dtype(event)] += n * f
        if kind:
            coll[kind] += n * c
    out = {"flops": flops, "traffic_bytes": traffic,
           "collective_bytes_total": sum(coll.values())}
    out.update({f"collective_{k}": v for k, v in coll.items()})
    out.update({f"flops_{d}": v for d, v in sorted(by_dtype.items())})
    return out
