"""CUDA kernel of the tree mechanism, bound with ctypes.

The counterpart of ``repro/kernels/tree_noise/kernel.py``; the source is
``csrc/tree_noise.cu`` (what it replaces, its bound and its design are
noted there). The wrapper launches on PyTorch's current stream, allocates
delta with ``torch.empty``, never synchronises, and raises when the launch
is refused. It adds one to `launches["tree_delta"]` when it launches, and
nowhere else, so a caller can show that a run went through the kernel.
`tree_delta_rows_cuda` advances g distinct owners in one launch and counts
one launch under the same name. On a paged bank `row_idx` names each
member's node row (its hot slot) apart from its owner, whose count it reads.
`repro_torch.telemetry.counters()` reads this `launches` in place, beside
the other kernels' and the pager's counters: the way to read them all.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

NAME = "tree_noise"
SOURCE = Path(__file__).resolve().parent / "csrc" / "tree_noise.cu"

launches: Dict[str, int] = {"tree_delta": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _library() -> ctypes.CDLL:
    lib = _build.load(NAME, SOURCE)
    lib.tree_delta_rows_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                                           _I, _I, _P]
    lib.tree_delta_rows_launch.restype = _I
    return lib


def tree_delta_rows_cuda(nodes: torch.Tensor, counts: torch.Tensor, owner_idx: torch.Tensor,
                         keys: torch.Tensor, noise_scale: torch.Tensor,
                         grant: Optional[torch.Tensor] = None,
                         row_idx: Optional[torch.Tensor] = None, col0: int = 0
                         ) -> torch.Tensor:
    """One launch for g owners: advance the rows of `owner_idx` ((g,) int64,
    DISTINCT: the kernel assumes it and does not check) of the (N, depth,
    P) f32 node tensor in place and return delta (g, P). Member m takes
    `keys[m]` ((g, 2) uint32), `noise_scale[m]` ((g,) f32) and `grant[m]`
    ((g,) int32, or None: all granted); `counts` is read, not bumped. Row m
    equals tree_delta_cuda on owner_idx[m] bit for bit. `row_idx` ((g,)
    int64, or None: the owners' own rows) is each member's node row, the
    hot slot of a paged bank; the counts are still read by owner. `col0` is
    the nodes' first column in a wider row: element i draws the bits of
    column col0 + i."""
    dev = nodes.device
    if dev.type != "cuda":
        raise ValueError(f"tree_delta_rows_cuda needs CUDA tensors, got {dev}")
    if nodes.dim() != 3:
        raise ValueError(f"nodes must be (N, depth, P), got shape {tuple(nodes.shape)}")
    _, depth, p = nodes.shape
    g = owner_idx.numel()
    _build.require(nodes, "nodes", torch.float32, dev, nodes.numel())
    # a paged bank's nodes hold n_hot rows; its counts stay one per owner
    _build.require(counts, "counts", torch.int32, dev, counts.numel())
    _build.require(owner_idx, "owner_idx", torch.int64, dev, g)
    if row_idx is not None:
        _build.require(row_idx, "row_idx", torch.int64, dev, g)
    _build.require(keys, "keys", torch.uint32, dev, 2 * g)
    _build.require(noise_scale, "noise_scale", torch.float32, dev, g)
    if grant is not None:
        _build.require(grant, "grant", torch.int32, dev, g)
    delta = torch.empty((g, p), dtype=torch.float32, device=dev)
    err = _library().tree_delta_rows_launch(
        nodes.data_ptr(), counts.data_ptr(), owner_idx.data_ptr(),
        None if row_idx is None else row_idx.data_ptr(), keys.data_ptr(),
        noise_scale.data_ptr(), None if grant is None else grant.data_ptr(),
        delta.data_ptr(), g, p, int(col0), depth, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "tree_delta")
    launches["tree_delta"] += 1
    return delta


def tree_delta_cuda(nodes: torch.Tensor, counts: torch.Tensor, owner_idx: torch.Tensor,
                    key: torch.Tensor, noise_scale: torch.Tensor,
                    grant: Optional[torch.Tensor] = None,
                    row_idx: Optional[torch.Tensor] = None, col0: int = 0) -> torch.Tensor:
    """Advance owner `owner_idx`'s row of the (N, depth, P) f32 node tensor
    in place and return delta (P,): the batched launch with one member.

    `counts` is the (N,) int32 leaf counter (read, not bumped), `owner_idx`
    a (1,) int64 index, `key` the round's (2,) uint32 key, `noise_scale` a
    one-element f32 tensor and `grant` None (granted) or a one-element
    int32 tensor, all on the nodes' device; `row_idx` a (1,) int64 node
    row apart from the owner (a paged bank's hot slot), or None."""
    return tree_delta_rows_cuda(nodes, counts, owner_idx, key, noise_scale, grant,
                                row_idx, col0)[0]
