"""Convex federation engine: Algorithm 1 (paper-faithful) on the device.

Counterpart of ``repro/federation/convex.py``. Per iteration k = 1..T
(eqs. 5-7):
    i_k ~ Schedule (uniform/Poisson/availability-trace)
    theta_bar = (theta_L + theta_{i_k}) / 2                       (6)
    Qbar     = Q_{i_k}(theta_bar) + Laplace(b_{i_k})              (4)
    theta_{i_k} = Proj[ theta_bar - (N rho / (T^2 sigma)) *
                        ( (1/2N) grad g(theta_bar) + (n_i/n) Qbar ) ]   (5)
    theta_L  = Proj[ theta_bar - ((N-1) rho / (N T^2 sigma)) grad g ]   (7)

The reference runs this as one ``lax.scan`` and ``vmap``s it over keys for
the replicas of Figs. 2/8. Here the replicas are a leading run axis R (a
(R, 2) batch of keys; a (2,) key is one run without the axis) and the T
steps a Python loop over device tensors. Everything random is drawn before
the loop, from the reference's keys in the reference's order:
``split(key) -> (k_sched, k_noise)``, the owner sequence from
``draw(k_sched, N, T)``, then ``noise_keys = split(k_noise, T)`` and step k
draws ``laplace(noise_keys[k], (p,))``. The loop reads nothing back to the
host; each step's theta_L is kept in a (R, T, p) buffer and psi computed
from it after the loop (under a cap, the masked theta_L).

The synchronous baseline (`sync_scan_engine`) queries every owner each
round: round k draws one (N, p) Laplace from ``fold_in(key, k)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import random
from repro_torch.federation.clocks import uniform_schedule
from repro_torch.federation.config import paper_rates
from repro_torch.federation.linear import LinearProblem, Owner, reg_grad, relative_fitness
from repro_torch.federation.privacy import capped_rounds, laplace_scale_theorem1


@dataclasses.dataclass(frozen=True)
class Algo1Config:
    horizon: int                 # T
    rho: float                   # step-size knob; alpha = rho / T^2
    sigma: float                 # strong-convexity modulus of g
    epsilons: Sequence[float]    # per-owner privacy budgets
    composition: str = "paper"   # 'paper' | 'per_owner_rounds' (beyond-paper)
    cap_slack: float = 2.0
    noiseless: bool = False      # eps -> inf (for cost-of-privacy deltas)


class Algo1Trace(NamedTuple):
    theta_L: torch.Tensor        # (p,) final central model
    psi: torch.Tensor            # (T,) relative fitness of theta_L over time
    owners_seq: torch.Tensor     # (T,) int32 i_k sequence
    theta_bank: torch.Tensor     # (N, p) final owner copies


class SyncTrace(NamedTuple):
    theta_L: torch.Tensor        # (p,) final central model
    psi: torch.Tensor            # (T,) relative fitness over rounds


def stack_gram(owners: Sequence[Owner]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack per-owner Gram payloads into the (N, ...) engine tensors."""
    A = torch.stack([o.A for o in owners])                      # (N, p, p)
    b = torch.stack([o.b for o in owners])                      # (N, p)
    n_i = torch.tensor([o.n for o in owners], dtype=torch.float32, device=A.device)
    return A, b, n_i


def _run_axis(key: torch.Tensor, device) -> Tuple[torch.Tensor, bool]:
    """(R, 2) keys on `device` and whether the caller gave one (2,) key."""
    key = key.to(device)
    if key.dim() == 1:
        return key.unsqueeze(0), True
    if key.dim() != 2:
        raise ValueError(f"keys are (2,) or (R, 2), got shape {tuple(key.shape)}")
    return key, False


def _squeeze(trace, one: bool):
    return type(trace)(*(t.squeeze(0) for t in trace)) if one else trace


def _draws(keys: torch.Tensor, n_owners: int, p: int, horizon: int, scales: torch.Tensor,
           draw: Optional[Callable]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (R, T) int32 owner sequences and the (R, T, p) scaled Laplace
    noise of R runs, in the reference's key order."""
    ks = random.split(keys)
    k_sched, k_noise = ks[:, 0], ks[:, 1]
    owners = (draw or uniform_schedule)(k_sched, n_owners, horizon)
    if tuple(owners.shape) != (keys.shape[0], horizon):
        raise ValueError(f"draw gave owner sequences of shape {tuple(owners.shape)} for "
                         f"{keys.shape[0]} keys; a schedule's draw takes a (R, 2) batch "
                         f"of keys and returns (R, {horizon})")
    noise = random.laplace(random.split(k_noise, horizon), (p,))          # (R, T, p)
    return owners.to(torch.int32), scales[owners.to(torch.int64)].unsqueeze(-1) * noise


def _steps(prob: LinearProblem, A: torch.Tensor, b: torch.Tensor, n_i: torch.Tensor,
           owners: torch.Tensor, noise: torch.Tensor, theta_L: torch.Tensor,
           bank: torch.Tensor, counts: Optional[torch.Tensor], *, rho: float, sigma: float,
           lr_scale: float, cap: Optional[int]) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """The asynchronous steps over R runs; yields (theta_L, bank) after each.

    `theta_L` (R, p) is replaced every step; `bank` (R, N, p) and, under a
    `cap`, the (R, N) int32 `counts` are updated in place (a refused step
    writes the owner's own row back and leaves theta_L as it was)."""
    R, T = owners.shape
    N, p = A.shape[0], A.shape[1]
    idx = owners.to(torch.int64).t().contiguous()                   # (T, R)
    A_seq, b_seq = A[idx], b[idx]                                   # (T, R, p, p), (T, R, p)
    w = n_i / torch.full_like(n_i, float(prob.n_total))             # n_i / n, a true division
    w_seq = w[idx].unsqueeze(-1)                                    # (T, R, 1)
    noise_t = noise.transpose(0, 1).contiguous()                    # (T, R, p)
    rows = idx.reshape(T, R, 1, 1).expand(T, R, 1, p)
    two_n = torch.full((), 2 * N, dtype=torch.float32, device=A.device)
    lr_own, lr_L = paper_rates(N, T, rho, sigma, lr_scale)
    tm = prob.theta_max
    for k in range(T):
        theta_i = bank.gather(1, rows[k]).squeeze(1)                               # (R, p)
        theta_bar = 0.5 * (theta_L + theta_i)                                      # (6)
        q = 2.0 * (torch.bmm(A_seq[k], theta_bar.unsqueeze(-1)).squeeze(-1) - b_seq[k])  # (3)
        qbar = q + noise_t[k]                                                      # (4)
        gg = reg_grad(prob, theta_bar)
        new_i = torch.clamp(theta_bar - lr_own * (gg / two_n + w_seq[k] * qbar), -tm, tm)  # (5)
        new_L = torch.clamp(theta_bar - lr_L * gg, -tm, tm)                        # (7)
        if cap is None:
            theta_L = new_L
            bank.scatter_(1, rows[k], new_i.unsqueeze(1))
        else:
            ik = idx[k].unsqueeze(1)                                               # (R, 1)
            respond = counts.gather(1, ik) < cap
            theta_L = torch.where(respond, new_L, theta_L)
            bank.scatter_(1, rows[k], torch.where(respond, new_i, theta_i).unsqueeze(1))
            counts.scatter_add_(1, ik, respond.to(torch.int32))
        yield theta_L, bank


def scan_engine(key: torch.Tensor, prob: LinearProblem, A: torch.Tensor, b: torch.Tensor,
                n_i: torch.Tensor, scales: torch.Tensor, *, horizon: int, rho: float,
                sigma: float, lr_scale: float = 1.0, draw: Optional[Callable] = None,
                cap: Optional[int] = None) -> Algo1Trace:
    """The asynchronous run over the owner schedule, on A's device.

    `key` is one (2,) key or a (R, 2) batch of R replicas (the trace then
    gains a leading R axis). `draw(keys, N, T) -> (R, T) int32` supplies
    the i_k sequences (default the i.i.d.-uniform shortcut). `cap`, when
    set, refuses an owner's round once it has responded `cap` times: the
    refused round is a no-op for both models."""
    keys, one = _run_axis(key, A.device)
    R, N, p = keys.shape[0], A.shape[0], prob.G.shape[0]
    scales = scales.to(device=A.device, dtype=torch.float32)
    owners, noise = _draws(keys, N, p, horizon, scales, draw)
    theta_L = torch.zeros((R, p), dtype=torch.float32, device=A.device)
    bank = torch.zeros((R, N, p), dtype=torch.float32, device=A.device)
    counts = None if cap is None else torch.zeros((R, N), dtype=torch.int32, device=A.device)
    hist = torch.empty((R, horizon, p), dtype=torch.float32, device=A.device)
    for k, (theta_L, bank) in enumerate(_steps(prob, A, b, n_i, owners, noise, theta_L, bank,
                                               counts, rho=rho, sigma=sigma,
                                               lr_scale=lr_scale, cap=cap)):
        hist[:, k] = theta_L
    trace = Algo1Trace(theta_L, relative_fitness(prob, hist), owners, bank)
    return _squeeze(trace, one)


def sync_scan_engine(key: torch.Tensor, prob: LinearProblem, A: torch.Tensor,
                     b: torch.Tensor, n_i: torch.Tensor, scales: torch.Tensor, *,
                     horizon: int, lr: float) -> SyncTrace:
    """Synchronous all-owners-per-round DP baseline (the [14]-style
    comparator the paper argues does not scale); the same per-owner budget
    split over T rounds. `key` as in `scan_engine`."""
    keys, one = _run_axis(key, A.device)
    R, N, p = keys.shape[0], A.shape[0], prob.G.shape[0]
    dev = A.device
    scales = scales.to(device=dev, dtype=torch.float32)
    round_keys = random.fold_in(keys.unsqueeze(1), torch.arange(horizon, device=dev))
    lap = random.laplace(round_keys, (N, p))                            # (R, T, N, p)
    noise = (scales[:, None] * lap).transpose(0, 1).contiguous()        # (T, R, N, p)
    w = n_i / torch.full_like(n_i, float(prob.n_total))
    theta = torch.zeros((R, p), dtype=torch.float32, device=dev)
    hist = torch.empty((R, horizon, p), dtype=torch.float32, device=dev)
    tm = prob.theta_max
    for k in range(horizon):
        q = 2.0 * (torch.einsum("npq,rq->rnp", A, theta) - b) + noise[k]
        g = reg_grad(prob, theta) + torch.einsum("n,rnp->rp", w, q)
        theta = torch.clamp(theta - lr * g, -tm, tm)
        hist[:, k] = theta
    return _squeeze(SyncTrace(theta, relative_fitness(prob, hist)), one)


def run_algorithm1(key: torch.Tensor, prob: LinearProblem, owners: List[Owner],
                   cfg: Algo1Config) -> Algo1Trace:
    """Legacy entry point, kept compatible with the reference's.

    Deliberate compatibility decision, as in the reference: with
    composition='per_owner_rounds' this path only RESCALES noise to the
    capped horizon and does not enforce the response cap the reduced scale
    relies on (owners drawn more than R_i times exceed their stated eps_i).
    The Federation session enforces the cap (refusal + ledger); use it for
    budget-honest capped runs."""
    T = cfg.horizon
    A, b, n_i = stack_gram(owners)
    if cfg.composition == "per_owner_rounds":
        T_eff = capped_rounds(T, len(owners), cfg.cap_slack)
    else:
        T_eff = T
    scales = torch.tensor([
        0.0 if cfg.noiseless else laplace_scale_theorem1(o.xi, T_eff, o.n, e)
        for o, e in zip(owners, cfg.epsilons)], dtype=torch.float32, device=A.device)
    return scan_engine(key, prob, A, b, n_i, scales, horizon=T, rho=cfg.rho, sigma=cfg.sigma)


def run_many(key: torch.Tensor, prob: LinearProblem, owners: List[Owner], cfg: Algo1Config,
             n_runs: int) -> Algo1Trace:
    """Multi-seed runs (percentile statistics of Figs. 2/8): replica r runs
    on row r of split(key, n_runs), on one leading run axis."""
    return run_algorithm1(random.split(key, n_runs), prob, owners, cfg)
