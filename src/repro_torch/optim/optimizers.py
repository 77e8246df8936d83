"""Minimal optax-style optimizers on trees of tensors. Counterpart of
``repro/optim/optimizers.py``: the same math, f32 state.

Each optimizer is (init_fn, update_fn):
    state = init_fn(params)
    updates, state = update_fn(grads, state, params)
    params = apply_updates(params, updates)

`lr` is a schedule, step -> lr (``optim.schedules``), called with the
state's int32 step count. `inertia_sgd` is the paper's Algorithm-1 update
rule as an optimizer transform: the constant rate alpha = N rho / (T^2
sigma) and the l_inf projection. It is stateless: the *inertia* lives in
the trainer (the theta_bar blend), not here.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.tree_util import tree_flatten, tree_map


class OptState(NamedTuple):
    mu: Any = None
    nu: Any = None
    count: Optional[torch.Tensor] = None


def _count(params) -> torch.Tensor:
    leaves = tree_flatten(params)[0]
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _f32_zeros(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates)


def sgd(lr: Callable[[torch.Tensor], torch.Tensor], momentum: float = 0.0):
    def init(params):
        return OptState(mu=_f32_zeros(params) if momentum else None, count=_count(params))

    def update(grads, state: OptState, params):
        del params
        rate = lr(state.count)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32), state.mu, grads)
            return tree_map(lambda m: -rate * m, mu), OptState(mu=mu, count=state.count + 1)
        upd = tree_map(lambda g: -rate * g.to(torch.float32), grads)
        return upd, OptState(count=state.count + 1)

    return init, update


def adamw(lr: Callable[[torch.Tensor], torch.Tensor], b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.0):
    def init(params):
        return OptState(mu=_f32_zeros(params), nu=_f32_zeros(params), count=_count(params))

    def update(grads, state: OptState, params):
        c = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
                      state.nu, grads)
        c1 = 1 - b1 ** c.to(torch.float32)
        c2 = 1 - b2 ** c.to(torch.float32)
        rate = lr(state.count)
        upd = tree_map(lambda m, v, p: -rate * ((m / c1) / (torch.sqrt(v / c2) + eps)
                                                + weight_decay * p.to(torch.float32)),
                       mu, nu, params)
        return upd, OptState(mu=mu, nu=nu, count=c)

    return init, update


def inertia_sgd(n_owners: int, horizon: int, rho: float, sigma: float, theta_max: float):
    """Algorithm 1's constant-rate projected step (owner-copy side, eq. 5)."""
    alpha = n_owners * rho / (horizon ** 2 * sigma)

    def init(params):
        return OptState(count=_count(params))

    def update(grads, state: OptState, params):
        upd = tree_map(lambda g, p: torch.clamp(
            p.to(torch.float32) - alpha * g.to(torch.float32), -theta_max, theta_max)
            - p.to(torch.float32), grads, params)
        return upd, OptState(count=state.count + 1)

    return init, update
