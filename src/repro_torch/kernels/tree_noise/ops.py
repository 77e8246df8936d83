"""Entry points of the tree_noise kernel: advance an owner's DP-FTRL noise
tree by one leaf.

    delta = tree_delta_(nodes, counts, owner_idx, key, noise_scale, grant)  # engine
    deltas = tree_delta_rows_(nodes, counts, owners, keys, noise_scales, grants)  # a group
    delta, new_nodes = tree_delta_row(nodes_row, count, key, noise_scale)

The counterpart of ``repro/kernels/tree_noise/ops.py``. The backend
follows the tensor: a CPU tensor runs the plain version from ``ref.py``; a
CUDA tensor launches the kernel from ``kernel.py``, and a failed build or
launch raises. There is no fallback from one to the other.

The Laplace bits are the round key's ``random.bits(key, (P,))`` stream on
both backends, the draw of the reference's off-TPU path
(``tree_delta_row(..., interpret="oracle")``): the plain version draws
them, the kernel hashes each element's index in-kernel (and its launch
reports the draw to an active key-reuse sanitizer through
``random.report_draw``).

`tree_delta_` updates the owner's row of the (N, depth, P) node tensor IN
PLACE (masked by the grant) and leaves the leaf counter to the caller: the
reference's gather, where and scatter of the whole (depth, P) row would
cost three row-sized transients per round. `tree_delta_rows_` is the
owner-parallel grouped driver's form (the reference's vmap of
`tree_delta_2d`): g distinct owners in one launch on CUDA, each member
bit for bit what `tree_delta_` gives it. On a paged bank, `row_idx` names
the node row (the owner's hot slot) apart from the owner, whose count is
read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import random
from repro_torch.kernels.tree_noise.kernel import tree_delta_cuda, tree_delta_rows_cuda
from repro_torch.kernels.tree_noise.ref import (tree_delta_inplace_ref,
                                               tree_delta_rows_inplace_ref)


def tree_delta_(nodes: torch.Tensor, counts: torch.Tensor, owner_idx: torch.Tensor,
                key: torch.Tensor, noise_scale: torch.Tensor,
                grant: Optional[torch.Tensor] = None,
                row_idx: Optional[torch.Tensor] = None, col0: int = 0) -> torch.Tensor:
    """Advance owner `owner_idx` ((1,) int64) by one leaf: its row of the
    (N, depth, P) f32 `nodes` is updated in place unless `grant` (a
    one-element int32 tensor; None = granted) is 0, and delta (P,) is
    returned. `counts` (N,) int32 is read, not bumped. `row_idx` ((1,)
    int64, or None) is the node row when it is not `owner_idx`'s own.
    `col0` is the nodes' first column in a wider row (a rank's slice on a
    device mesh): element i draws the bits of column col0 + i."""
    if nodes.device.type == "cpu":
        p = nodes.shape[-1]
        return tree_delta_inplace_ref(nodes, counts, owner_idx,
                                      random.bits_range(key, col0, col0 + p), noise_scale,
                                      grant, row_idx)
    if nodes.device.type == "cuda":
        random.report_draw("tree_delta_", key, col0, col0 + nodes.shape[-1])
        return tree_delta_cuda(nodes, counts, owner_idx, key, noise_scale, grant, row_idx,
                               col0)
    raise ValueError(f"tree_delta_: tensors on {nodes.device} are not supported "
                     "(cpu runs the plain version, cuda the kernel)")


def tree_delta_rows_(nodes: torch.Tensor, counts: torch.Tensor, owner_idx: torch.Tensor,
                     keys: torch.Tensor, noise_scale: torch.Tensor,
                     grant: Optional[torch.Tensor] = None,
                     row_idx: Optional[torch.Tensor] = None, col0: int = 0) -> torch.Tensor:
    """Advance g DISTINCT owners (`owner_idx` (g,) int64) by one leaf each:
    member m's row of `nodes` is updated in place unless grant[m] ((g,)
    int32; None = all granted) is 0, drawing random.bits(keys[m], (P,))
    ((g, 2) keys) at noise_scale[m] ((g,)); returns delta (g, P). Distinct
    owners are the conflict-free partition's invariant: checked on the CPU,
    assumed on CUDA (a check there would read the owners back). `row_idx`
    ((g,) int64, or None) are the members' node rows on a paged bank: the
    resident members' slots are distinct, and a member that missed the page
    table has grant 0 and writes no node. `col0` as in `tree_delta_`."""
    if nodes.device.type == "cpu":
        if torch.unique(owner_idx).numel() != owner_idx.numel():
            raise ValueError(f"tree_delta_rows_ needs distinct owners, got "
                             f"{owner_idx.tolist()}")
        p = nodes.shape[-1]
        return tree_delta_rows_inplace_ref(nodes, counts, owner_idx,
                                           random.bits_range(keys, col0, col0 + p),
                                           noise_scale, grant, row_idx)
    if nodes.device.type == "cuda":
        random.report_draw("tree_delta_rows_", keys, col0, col0 + nodes.shape[-1])
        return tree_delta_rows_cuda(nodes, counts, owner_idx, keys, noise_scale, grant,
                                    row_idx, col0)
    raise ValueError(f"tree_delta_rows_: tensors on {nodes.device} are not supported "
                     "(cpu runs the plain version, cuda the kernel)")


def tree_delta_row(nodes: torch.Tensor, count, key: torch.Tensor, noise_scale
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(delta (P,), new_nodes (depth, P)) for one leaf of one owner's
    (depth, P) f32 node row, as the reference's ``tree_delta_row``: the
    row is copied and advanced by `tree_delta_`."""
    dev = nodes.device
    work = nodes.to(torch.float32).unsqueeze(0).clone()
    counts = torch.as_tensor(count, dtype=torch.int32, device=dev).reshape(1)
    scale = torch.as_tensor(noise_scale, dtype=torch.float32, device=dev).reshape(1)
    owner = torch.zeros(1, dtype=torch.int64, device=dev)
    delta = tree_delta_(work, counts, owner, key.to(dev), scale)
    return delta, work[0]
