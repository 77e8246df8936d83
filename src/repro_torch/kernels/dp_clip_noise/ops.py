"""Entry points of the dp_clip_noise kernels: the flat round engine's
(`dp_round_flat`, `fused_sqnorm`) and the pytree privatizer's
(`fused_sqnorm_tree`, `fused_scale_noise_tree`, `dp_privatize_tree`).

    noisy = dp_privatize_tree(grads, key, xi, noise_scale)   # clip + noise a tree

`dp_round_rows` and `fused_sqnorm_rows` are the owner-parallel grouped
driver's forms (the reference's vmap of `dp_round_2d` and `sqnorm_2d`): a
leading member axis of g rows, one launch for all of them on CUDA, and
row m equal to the single-row entry point on row m bit for bit on either
backend.

The counterpart of ``repro/kernels/dp_clip_noise/ops.py``. The backend
follows the tensor: a CPU tensor runs the plain version from ``ref.py``; a
CUDA tensor launches the kernel from ``kernel.py``, and a failed build or
launch raises. There is no fallback from one to the other.

The Laplace bits are the key's ``random.bits(key, shape)`` stream on both
backends: the plain version draws them, the kernel hashes each element's
index in-kernel (and its launch reports the draw to an active key-reuse
sanitizer through ``random.report_draw``). Both therefore see the noise
the reference's off-TPU path draws (``interpret="oracle"``). A tree's
leaves take the rows of one ``split(key, n_leaves)``, in jax's leaf order.
The reference's Pallas layout knobs (``block_rows``, ``interpret``) have
no counterpart here: the kernels mask their tails instead of padding to
(rows, 1024) blocks.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch import random
from repro_torch.sharding import spmd
from repro_torch.tree_util import tree_flatten, tree_unflatten
from repro_torch.kernels.dp_clip_noise.kernel import (dp_round_cuda, dp_round_rows_cuda,
                                                      scale_noise_cuda, sqnorm_cuda,
                                                      sqnorm_rows_cuda)
from repro_torch.kernels.dp_clip_noise.ref import (dp_round_ref, dp_round_rows_ref,
                                                   scale_noise_ref, sqnorm_ref,
                                                   sqnorm_rows_ref)


def _unsupported(t: torch.Tensor, op: str) -> ValueError:
    return ValueError(f"{op}: tensors on {t.device} are not supported "
                      "(cpu runs the plain version, cuda the kernel)")


def dp_round_flat(tb: torch.Tensor, acc: torch.Tensor, key: torch.Tensor,
                  gain, noise_scale, w, *, sigma: float, lr_own: float,
                  lr_l: float, n_owners: int, theta_max: float, col0: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole inertia round on a (P,) f32 buffer -> (new_L, new_i): group
    mean (`gain`), the Laplace add (eq. 4), eqs. (5)/(7) and the theta_max
    projection in one pass. On CUDA, `gain`, `noise_scale` and `w` are
    one-element device tensors. `col0` is the buffer's first column in a
    wider row (a rank's slice on a device mesh): element i draws the bits
    of column col0 + i, so the slices of a row equal its columns."""
    if tb.device.type == "cpu":
        return dp_round_ref(tb, acc, random.bits_range(key, col0, col0 + tb.shape[0]), gain,
                            noise_scale, w, sigma=sigma, lr_own=lr_own, lr_l=lr_l,
                            n_owners=n_owners, theta_max=theta_max)
    if tb.device.type == "cuda":
        random.report_draw("dp_round_flat", key, col0, col0 + tb.shape[0])
        return dp_round_cuda(tb, acc, key, gain, noise_scale, w, sigma=sigma,
                             lr_own=lr_own, lr_l=lr_l, inv_2n=1.0 / (2 * n_owners),
                             theta_max=theta_max, col0=col0)
    raise _unsupported(tb, "dp_round_flat")


def fused_sqnorm(g: torch.Tensor) -> torch.Tensor:
    """Squared L2 norm of a flat f32 gradient as a 0-d tensor (the clip
    norm of one microbatch, before the square root)."""
    if g.device.type == "cpu":
        return sqnorm_ref(g)
    if g.device.type == "cuda":
        return sqnorm_cuda(g)
    raise _unsupported(g, "fused_sqnorm")


def dp_round_rows(tb: torch.Tensor, acc: torch.Tensor, keys: torch.Tensor,
                  gain: torch.Tensor, noise_scale: torch.Tensor, w: torch.Tensor, *,
                  sigma: float, lr_own: float, lr_l: float, n_owners: int,
                  theta_max: float, col0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """`dp_round_flat` over g members -> (new_L, new_i), each (g, P): tb and
    acc (g, P) f32, keys (g, 2) uint32 (row m draws random.bits(keys[m],
    (P,)), from column `col0` of a wider row), gain, noise_scale and w (g,)
    f32 device tensors."""
    kw = dict(sigma=sigma, lr_own=lr_own, lr_l=lr_l, theta_max=theta_max)
    if tb.device.type == "cpu":
        return dp_round_rows_ref(tb, acc, random.bits_range(keys, col0, col0 + tb.shape[-1]),
                                 gain, noise_scale, w, n_owners=n_owners, **kw)
    if tb.device.type == "cuda":
        random.report_draw("dp_round_rows", keys, col0, col0 + tb.shape[-1])
        return dp_round_rows_cuda(tb, acc, keys, gain, noise_scale, w,
                                  inv_2n=1.0 / (2 * n_owners), col0=col0, **kw)
    raise _unsupported(tb, "dp_round_rows")


def fused_sqnorm_rows(g: torch.Tensor) -> torch.Tensor:
    """Squared L2 norm of each row of a (g, P) f32 tensor -> (g,): the clip
    norms of g members' microbatch gradients, in one launch on CUDA."""
    if g.device.type == "cpu":
        return sqnorm_rows_ref(g)
    if g.device.type == "cuda":
        return sqnorm_rows_cuda(g)
    raise _unsupported(g, "fused_sqnorm_rows")


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A one-element f32 tensor on `like`'s device: a float is filled in
    there (no copy from the host), a tensor reshaped (never read back)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).reshape(1)
    return torch.full((1,), v, dtype=torch.float32, device=like.device)


def _block_layout(shape: Sequence[int], offsets: Sequence[int], local_shape: Sequence[int]
                  ) -> Tuple[int, int, int, int, int]:
    """(base, R, C, SR, SA) of the block of `local_shape` at `offsets` of a
    row-major leaf of `shape`: the block, contiguous, seen as (A, R, C),
    element (a, r, c) at the leaf's flat index base + a*SA + r*SR + c.

    Dims of one element drop out; a dim joins the one before it when the
    block holds it whole, so the groups start at the block's first dim and
    at each dim the block cuts. A block cut on at most two dims (a leaf
    sharded on two mesh axes, any stacked dims in front) has at most three
    groups; the whole leaf, or one range of it, is the single group C =
    numel."""
    shape, offsets = tuple(int(d) for d in shape), tuple(int(o) for o in offsets)
    local_shape = tuple(int(n) for n in local_shape)
    strides, st = [0] * len(shape), 1
    for j in reversed(range(len(shape))):
        strides[j] = st
        st *= shape[j]
    base = sum(o * s for o, s in zip(offsets, strides))
    groups: list = []                   # [size, stride of its last dim]
    cut = False                         # a dim of one element cut since the last group
    for j, n in enumerate(local_shape):
        if n == 1:
            cut = cut or shape[j] > 1
            continue
        if groups and n == shape[j] and not cut:
            groups[-1] = [groups[-1][0] * n, strides[j]]
        else:
            groups.append([n, strides[j]])
        cut = False
    if not groups:
        return base, 1, 1, 1, 1
    if groups[-1][1] != 1:              # the innermost dims cut to one element: C = 1
        groups.append([1, 1])
    if len(groups) > 3:
        raise NotImplementedError(f"a block of {local_shape} of a leaf of {shape} is cut on "
                                  "more than two dims; scale_noise takes at most (A, R, C)")
    while len(groups) < 3:
        groups.insert(0, [1, 0])
    (_, sa), (r, sr), (c, _) = groups
    return base, r, c, sr, sa


def scale_noise(g: torch.Tensor, key: torch.Tensor, clip_scale, noise_scale,
                block: Optional[Tuple[Sequence[int], Sequence[int]]] = None) -> torch.Tensor:
    """g * clip_scale + noise_scale * Laplace(bits(key, g.shape)) for one
    f32 leaf, in one pass on CUDA. `block` = (the leaf's global shape, the
    offsets of g in it) makes g a rank's block of that leaf: it draws the
    bits of its own elements of the unsharded leaf (`random.bits_block`),
    so the blocks of a leaf tile the whole launch."""
    if g.device.type == "cpu":
        bits = (random.bits(key, g.shape) if block is None
                else random.bits_block(key, block[0], block[1], g.shape))
        return scale_noise_ref(g, bits, _scalar(clip_scale, g).reshape(()),
                               _scalar(noise_scale, g).reshape(()))
    if g.device.type == "cuda":
        random.report_draw("scale_noise", key, 0, g.numel(),
                           block=None if block is None else (block[0], block[1], g.shape))
        layout = None if block is None else _block_layout(block[0], block[1], g.shape)
        return scale_noise_cuda(g, key, _scalar(clip_scale, g), _scalar(noise_scale, g),
                                layout)
    raise _unsupported(g, "scale_noise")


def fused_sqnorm_tree(tree: Any) -> torch.Tensor:
    """Global squared L2 norm of a tree: one `fused_sqnorm` per leaf (a
    bf16 or f16 leaf upcast to f32 first), summed in leaf order. On
    DTensor leaves each rank runs `sqnorm` on its own block and the
    blocks' sums are summed over the mesh dims that shard the leaf
    (`spmd.tree_total`); the total is a replicated 0-d DTensor."""
    leaves, _ = tree_flatten(tree)
    return spmd.tree_total(leaves, lambda leaf: fused_sqnorm(_f32(leaf)))


def fused_scale_noise_tree(tree: Any, key: torch.Tensor, gain, noise_scale) -> Any:
    """leaf * gain + Laplace(noise_scale) for every leaf, one `scale_noise`
    pass each (in f32, the result cast back to the leaf's dtype, as the
    reference's); leaf i draws from row i of split(key, n_leaves). `gain` and
    `noise_scale` may be floats or one-element device tensors (a clip
    factor, an owner's scale), so nothing syncs with the host. A DTensor
    leaf runs its local block through the pass with the block's offsets,
    so each rank draws its own block of the leaf's noise and no rank
    builds the whole leaf."""
    leaves, treedef = tree_flatten(tree)
    keys = random.split(key, len(leaves))
    gain, noise_scale = spmd.plain(gain), spmd.plain(noise_scale)
    out = []
    for leaf, k in zip(leaves, keys):
        if spmd.is_dtensor(leaf):
            local, shape, offsets = spmd.local_block(leaf)
            y = scale_noise(_f32(local), k, gain, noise_scale, (shape, offsets))
            out.append(spmd.like(leaf, y.to(leaf.dtype)))
        else:
            out.append(scale_noise(_f32(leaf), k, gain, noise_scale).to(leaf.dtype))
    return tree_unflatten(treedef, out)


def _f32(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf as the kernels take it: contiguous f32 (a bf16 or f16 leaf
    upcast, which is exact, as the reference's `_pack` does); an f32 leaf
    as it is."""
    return leaf.to(torch.float32).contiguous()


def dp_privatize_tree(grads: Any, key: torch.Tensor, xi: float, noise_scale) -> Any:
    """Clip a gradient tree to global L2 norm xi and add Laplace(noise_scale)
    noise: the per-leaf `sqnorm` passes, the clip factor min(1, xi /
    max(norm, 1e-12)) on the device, then `fused_scale_noise_tree`."""
    norm = torch.sqrt(fused_sqnorm_tree(grads))
    clip = torch.clamp(torch.full_like(norm, xi) / torch.clamp(norm, min=1e-12), max=1.0)
    return fused_scale_noise_tree(grads, key, clip, noise_scale)
