"""Plain PyTorch versions of the tree_noise kernel.

The counterpart of ``repro/kernels/tree_noise/ref.py``. DP-FTRL binary
counter (Kairouz et al. 2021): advancing an owner's leaf count from t to
t+1 retires the node at every level that held a trailing one bit of t,
puts ONE fresh draw at the level of the lowest set bit of t+1, and leaves
the higher levels alone. The per-round noise delta is the fresh draw
minus the retired nodes, so the cumulative noise after t leaves telescopes
to the sum of the active nodes: popcount(t) draws instead of t.

The retired levels are summed first, one level at a time in increasing
order, and the sum is subtracted from the draw, as the reference's oracle
does. The CUDA kernel sums in the same order, so the two give the same
bits on the card. The wrappers in ``ops.py`` run these on CPU tensors, and
the chip smoke script holds the kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.dp_clip_noise.ref import laplace_from_bits_ref


def tree_masks_ref(count, depth: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(retired, fresh) (depth,) bool masks for the count -> count+1 leaf.

    Level l retires iff 2^(l+1) divides count+1, and is fresh iff
    (count+1) mod 2^(l+1) == 2^l. `count` is an int or an integer tensor;
    the masks land on `device` (None: the count's device, the CPU for an
    int)."""
    t1 = torch.as_tensor(count, device=device).to(torch.int64).reshape(()) + 1
    lvl = torch.arange(depth, dtype=torch.int64, device=t1.device)
    rem = torch.remainder(t1, torch.ones_like(lvl) << (lvl + 1))
    return rem == 0, rem == (torch.ones_like(lvl) << lvl)


def tree_delta_ref(nodes: torch.Tensor, bits: torch.Tensor, count, noise_scale
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf increment -> (delta (P,), new_nodes (depth, P)).

    `nodes` (depth, P) f32 holds one owner's scaled node noise, `bits` (P,)
    uint32 feed the fresh draw, `count` is the leaves released before this
    one and `noise_scale` the per-node scale (a float or a one-element
    tensor). Depth 0 is fresh noise with no retirement: the per-round
    Laplace mechanism."""
    depth = nodes.shape[0]
    zeta = noise_scale * laplace_from_bits_ref(bits)
    if depth == 0:
        return zeta, nodes
    retired, fresh = tree_masks_ref(count, depth, device=nodes.device)
    retired_sum = torch.zeros_like(zeta)
    for lvl in range(depth):
        retired_sum = retired_sum + torch.where(retired[lvl], nodes[lvl], 0.0)
    delta = zeta - retired_sum
    new_nodes = torch.where(fresh[:, None], zeta[None],
                            torch.where(retired[:, None], 0.0, nodes))
    return delta, new_nodes


def tree_delta_inplace_ref(nodes: torch.Tensor, counts: torch.Tensor,
                           owner_idx: torch.Tensor, bits: torch.Tensor, noise_scale,
                           grant: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The engine's form: advance owner `owner_idx`'s row of the (N, depth,
    P) node tensor IN PLACE and return delta (P,). `counts` (N,) int32 is
    read, not bumped (the caller adds the grant afterwards); `owner_idx` is
    a (1,) int64 index. With `grant` (an int tensor of one element) 0 no
    node changes; delta is returned all the same."""
    row = nodes.index_select(0, owner_idx)[0]
    delta, new_row = tree_delta_ref(row, bits, counts.index_select(0, owner_idx), noise_scale)
    if nodes.shape[1]:
        if grant is not None:
            new_row = torch.where(grant.reshape(()) != 0, new_row, row)
        nodes.index_copy_(0, owner_idx, new_row.unsqueeze(0))
    return delta


def tree_delta_rows_inplace_ref(nodes: torch.Tensor, counts: torch.Tensor,
                                owner_idx: torch.Tensor, bits: torch.Tensor,
                                noise_scale: torch.Tensor,
                                grant: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`tree_delta_inplace_ref` for g distinct owners ((g,) int64), one
    after another: member m draws from bits[m] ((g, P)) with noise_scale[m]
    and grant[m]; returns delta (g, P), row m bit for bit the single call's."""
    return torch.stack([tree_delta_inplace_ref(nodes, counts, owner_idx[m:m + 1], bits[m],
                                               noise_scale[m:m + 1],
                                               None if grant is None else grant[m:m + 1])
                        for m in range(owner_idx.numel())])
