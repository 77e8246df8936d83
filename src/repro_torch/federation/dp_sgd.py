"""Gradient privatization: Xi enforced by clipping, then the DP response.

Counterpart of ``repro/federation/dp_sgd.py``. Assumption 2 (bounded
per-record gradient) does not hold for transformers; it is enforced by
clipping before averaging. Granularities:

  'example'    -- per-example gradients through torch.func.vmap(grad),
                  each clipped to xi, then averaged. Memory O(batch *
                  params): small models and tests.
  'microbatch' -- a loop over G microbatch groups; each group gradient is
                  clipped to xi and the groups are averaged (the DP
                  adjacency unit is a group). Memory O(params).

`private_grad` is the pytree privatizer (the reference's default path):
the clipped mean plus Laplace (or Gaussian) noise at the Theorem-1 scale.
With ``fused_kernel=True`` the clip norm runs through the `sqnorm` kernel
per leaf and the group mean and Laplace add through one `scale_noise`
pass per leaf (`kernels/dp_clip_noise`); the in-kernel inverse-CDF draw
is another lawful Laplace sample than `random.laplace`, so the two
backends agree in distribution, not bit for bit. The flat engine
(`deep._flat_clipped_grad_acc`) shares the config.

On a device mesh (the params a tree of DTensors, `launch.steps`) the
privatizer runs on each rank's blocks: the gradients come back in the
parameters' placements, the clip norm sums each rank's blocks and reduces
them over the mesh, and each leaf's noise is drawn block by block
(`privacy.noise_tree`, or `scale_noise` with the block's offsets), so a
meshed round draws the unmeshed round's noise. Per example,
torch.func.vmap does not pass through a model on DTensors (its batching
meets `sharding.spmd`'s regions and collectives, and DTensor refuses the
batched views), so the B per-example gradients are B backward passes of a
batch of one on the meshed model (`_example_grads_meshed`): memory O(B x
this rank's block), each example's norm the sum of its blocks' partials
reduced over the mesh, then the reference's scale and mean. Those
gradients are not vmap's bits, so a meshed example round equals the
unmeshed one to float rounding, not bit for bit.

The reference's ``kernel_block_rows`` and ``kernel_interpret`` are layout
knobs of its TPU kernels and have no counterpart here: the CUDA kernels
mask their tails, and the tensor's device picks the backend.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import random
from repro_torch.federation.privacy import laplace_noise_tree, noise_tree
from repro_torch.kernels.dp_clip_noise.ops import fused_scale_noise_tree, fused_sqnorm_tree
from repro_torch.sharding import spmd
from repro_torch.tree_util import tree_flatten, tree_map, tree_unflatten

LossFn = Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PrivatizerConfig:
    xi: float                        # clip norm (== Assumption-2 bound)
    granularity: str = "microbatch"  # 'example' | 'microbatch'
    n_microbatches: int = 8
    mechanism: str = "laplace"       # 'laplace' | 'gaussian' (beyond-paper)
    # batch leaves arrive (G, B/G, ...) microbatch-major instead of (B, ...)
    pre_grouped: bool = False
    # route the clip norm and the mean + Laplace add through the
    # dp_clip_noise kernels (laplace only); the flat engine also fuses the
    # inertia updates into its `dp_round` pass
    fused_kernel: bool = False


def _group_batch(batch: Dict[str, torch.Tensor], n_groups: int) -> Dict[str, torch.Tensor]:
    """Reshape every leaf (B, ...) -> (G, B/G, ...)."""
    return {k: a.reshape((n_groups, a.shape[0] // n_groups) + tuple(a.shape[1:]))
            for k, a in batch.items()}


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in jax's order) of each leaf's sum of
    squares, in f32; on DTensor leaves each rank's blocks' sums reduced
    over the mesh (`spmd.tree_total`), a replicated 0-d DTensor."""
    leaves, _ = tree_flatten(tree)
    return torch.sqrt(spmd.tree_total(
        leaves, lambda leaf: torch.sum(torch.square(leaf.to(torch.float32)))))


def _clip_factor(norm: torch.Tensor, xi: float) -> torch.Tensor:
    """min(1, xi / max(norm, 1e-12)) on norm's device, a true f32 division
    (a python-scalar dividend would be a reciprocal multiply)."""
    return torch.clamp(torch.full_like(norm, xi) / torch.clamp(norm, min=1e-12), max=1.0)


def clip_tree(tree, max_norm: float):
    """(tree scaled to global L2 norm <= max_norm, its norm before)."""
    norm = _global_norm(tree)
    scale = _clip_factor(norm, max_norm)
    return tree_map(lambda leaf: (leaf.to(torch.float32) * scale).to(leaf.dtype), tree), norm


def _tree_grad(loss_fn: LossFn, params, batch):
    """The gradient tree of loss_fn(params, batch) at `params`, by autograd
    on detached copies of the leaves (the caller's tensors are left as
    they are)."""
    leaves, treedef = tree_flatten(params)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss = loss_fn(tree_unflatten(treedef, live), batch)
    # on a mesh the backward meets the forward's saved constants too
    with spmd.replicating(*live):
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return tree_unflatten(treedef, [torch.zeros_like(x) if g is None else _laid_out(g, x)
                                    for x, g in zip(live, grads)])


def _laid_out(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's placements (partial sums reduced); a
    plain gradient as it is."""
    if not spmd.is_dtensor(g) or tuple(g.placements) == tuple(like.placements):
        return g
    return g.redistribute(like.device_mesh, like.placements)


def _example_grads(loss_fn: LossFn, params, batch):
    """Per-example gradients -> (leaves (B, ...) in jax's order, treedef):
    vmap over the batch of the gradient at a batch of one. torch.func sees
    the leaf list, never the tree (whose None fields it would refuse)."""
    leaves, treedef = tree_flatten(params)

    def one(ex):
        ex1 = {k: v.unsqueeze(0) for k, v in ex.items()}
        return torch.func.grad(lambda ls: loss_fn(tree_unflatten(treedef, ls), ex1))(leaves)

    return torch.func.vmap(one)(batch), treedef


def _example_grads_meshed(loss_fn: LossFn, params, batch):
    """`_example_grads` on DTensor params: B backward passes of a batch of
    one (`_tree_grad`, the meshed autograd), stacked leaf by leaf into (B,
    ...) DTensors laid out as the leaf on its dims. A batch leaf that is a
    DTensor is read whole: the examples are a host-side split of a few
    token rows."""
    rows = {k: v.full_tensor() if spmd.is_dtensor(v) else v for k, v in batch.items()}
    B = next(iter(rows.values())).shape[0]
    per = [tree_flatten(_tree_grad(loss_fn, params, {k: v[b:b + 1] for k, v in rows.items()}))
           for b in range(B)]
    treedef = per[0][1]
    return [torch.stack([p[0][i] for p in per]) for i in range(len(per[0][0]))], treedef


def _example_norms(g_leaves, B: int) -> torch.Tensor:
    """(B,) per-example L2 norms of the (B, ...) gradient leaves, each
    leaf's per-example sum of squares added in leaf order; on DTensor
    leaves each rank's blocks' sums reduced over the mesh
    (`spmd.tree_total`)."""
    return torch.sqrt(spmd.tree_total(
        g_leaves, lambda g: torch.sum(torch.square(g.to(torch.float32).reshape(B, -1)), dim=1)))


def private_grad(loss_fn: LossFn, params, batch: Dict[str, torch.Tensor], key: torch.Tensor,
                 *, cfg: PrivatizerConfig, noise_scale, return_noise: bool = False
                 ) -> Tuple[Any, ...]:
    """Clipped-average gradient + mechanism noise (the DP response, eq. 4).

    `noise_scale` is the Theorem-1 scale of the averaged query (a float or
    a 0-d tensor on the params' device). Returns (noisy gradient tree,
    metrics); `return_noise=True` appends the drawn noise tree as a third
    value without changing the draw (the tree mechanism installs it as the
    fresh node), and raises under `fused_kernel`, whose noise never leaves
    the kernel."""
    if return_noise and cfg.fused_kernel:
        raise ValueError("return_noise requires the jnp mechanism path "
                         "(fused_kernel adds noise in-kernel)")
    leaves = tree_flatten(params)[0]
    # on a mesh the round's own scalars (xi, the counters) stand for the
    # same values on every rank
    with spmd.replicating(*leaves):
        return _private_grad(loss_fn, params, batch, key, cfg, noise_scale, return_noise)


def _private_grad(loss_fn, params, batch, key, cfg, noise_scale, return_noise):
    first = next(iter(batch.values()))
    B = first.shape[0]
    if cfg.pre_grouped and cfg.granularity == "microbatch":
        B = cfg.n_microbatches * first.shape[1]
    dev = tree_flatten(params)[0][0].device
    xi = torch.full((), cfg.xi, dtype=torch.float32, device=dev)

    if cfg.granularity == "example":
        grads = (_example_grads if spmd.mesh_of(*tree_flatten(params)[0]) is None
                 else _example_grads_meshed)
        g_leaves, treedef = grads(loss_fn, params, batch)               # leaves (B, ...)
        norms = _example_norms(g_leaves, B)
        scale = _clip_factor(norms, cfg.xi)
        mean_grad = tree_unflatten(treedef, [
            torch.mean(g.to(torch.float32) * scale.reshape((-1,) + (1,) * (g.dim() - 1)),
                       dim=0) for g in g_leaves])
        clip_frac = torch.mean((norms > xi).to(torch.float32))
        max_norm = torch.max(norms)
    elif cfg.granularity == "microbatch":
        G = cfg.n_microbatches
        if B % G:
            raise ValueError(f"batch of {B} does not split into {G} microbatches")
        xs = batch if cfg.pre_grouped else _group_batch(batch, G)
        acc = tree_map(lambda leaf: torch.zeros_like(leaf, dtype=torch.float32), params)
        nclip = torch.zeros((), dtype=torch.float32, device=dev)
        mx = torch.zeros((), dtype=torch.float32, device=dev)
        for gi in range(G):
            g = _tree_grad(loss_fn, params, {k: a[gi] for k, a in xs.items()})
            if cfg.fused_kernel:
                norm = torch.sqrt(fused_sqnorm_tree(g))
                s = _clip_factor(norm, cfg.xi)
                g = tree_map(lambda leaf: (leaf.to(torch.float32) * s).to(leaf.dtype), g)
            else:
                g, norm = clip_tree(g, cfg.xi)
            acc = tree_map(lambda a, x: a + x.to(torch.float32), acc, g)
            nclip = nclip + (norm > xi)
            mx = torch.maximum(mx, norm)
        g_count = torch.full((), G, dtype=torch.float32, device=dev)
        # the fused pass divides by G itself (gain 1/G): no mean pass there
        mean_grad = None if cfg.fused_kernel else tree_map(lambda a: a / g_count, acc)
        clip_frac = nclip / g_count
        max_norm = mx
    else:
        raise ValueError(cfg.granularity)
    metrics = {"clip_frac": clip_frac, "max_grad_norm": max_norm}

    if cfg.fused_kernel:
        if cfg.mechanism != "laplace":
            raise ValueError("fused_kernel implements the laplace mechanism")
        # one pass per leaf: the group-mean divide (gain 1/G) and the
        # Laplace add; for 'example' the mean is already taken
        src, gain = ((acc, 1.0 / G) if cfg.granularity == "microbatch"
                     else (mean_grad, 1.0))
        gain = torch.full((), gain, dtype=torch.float32, device=dev)
        return fused_scale_noise_tree(src, key, gain, noise_scale), metrics

    if cfg.mechanism == "laplace":
        noise = laplace_noise_tree(key, mean_grad, noise_scale)
    elif cfg.mechanism == "gaussian":
        noise = noise_tree(random.normal, key, mean_grad, noise_scale)
    else:
        raise ValueError(cfg.mechanism)
    noisy = tree_map(lambda g, w: g + w, mean_grad, noise)
    if return_noise:
        return noisy, metrics, noise
    return noisy, metrics
