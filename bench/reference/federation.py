"""The paper's asynchronous DP rounds in plain PyTorch: the schedule, the
owner-parallel grouping, the clipped and noised gradient, the inertia
updates and the ledger, as the benchmark's reference.

One round for owner i with key k, on the flat (P,) model (leaves packed in
`model.layout` order; the noise of element j hashes counter j of k):

    theta_bar = (theta_L + theta_i) / 2                              (6)
    acc       = sum over G microbatches of  g * min(1, xi / |g|)     (clip)
    q         = acc / G + b_i * Laplace(bits(k))                     (4)
    theta_i   <- Pi[theta_bar - lr_own (sigma theta_bar / 2N + w_i q)]   (5)
    theta_L   <- Pi[theta_bar - lr_L sigma theta_bar]                (7)

with b_i = 2 xi T / (n_i eps_i) (Theorem 1), w_i = n_i / n, Pi the clip to
+-theta_max, and the rates of `rates`. A round is granted while the owner
has answered fewer than T rounds; a refused round changes nothing.

The grouped schedule splits a dispatch into maximal runs of distinct
owners (capped), computes every member of a run from the run's entry
state, writes each member's own row, and sets theta_L to the mean of the
granted members' eq. (7) targets.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bench.reference import model as M
from bench.reference import threefry as T

BLOCK = T.BLOCK


@dataclass(frozen=True)
class FedSpec:
    n_owners: int
    records: int
    batch: int
    seq: int
    microbatches: int
    epsilon: float
    horizon: int
    xi: float
    target_lr: float
    sigma: float
    theta_max: float
    driver: str                        # "sequential" or "grouped"
    max_group: Optional[object] = None  # grouped: "auto" or an int cap

    @classmethod
    def from_traffic(cls, t: dict) -> "FedSpec":
        return cls(n_owners=t["owners"], records=t["records_per_owner"], batch=t["batch"],
                   seq=t["seq"], microbatches=t["microbatches"], epsilon=t["epsilon"],
                   horizon=t["horizon"], xi=t["xi"], target_lr=t["target_lr"],
                   sigma=t["sigma"], theta_max=t["theta_max"], driver=t["driver"],
                   max_group=t.get("max_group"))


def rates(f: FedSpec) -> Tuple[float, float]:
    """(lr_own, lr_L): the paper's rates with the step-size scale pinned so
    that lr_own is the traffic's target rate (rho = 1)."""
    scale = f.target_lr * f.horizon ** 2 * f.sigma / f.n_owners
    lr_own = scale * f.n_owners / (f.horizon ** 2 * f.sigma)
    lr_l = scale * (f.n_owners - 1) / (f.n_owners * f.horizon ** 2 * f.sigma)
    return lr_own, lr_l


def noise_scale(f: FedSpec) -> float:
    """Theorem 1's Laplace scale of one owner's averaged clipped gradient."""
    return 2.0 * f.xi * f.horizon / (f.records * f.epsilon)


# ------------------------------ schedule ------------------------------------
def owner_sequence(key: torch.Tensor, f: FedSpec, n: int) -> torch.Tensor:
    """The uniform schedule: n owners drawn i.i.d. (jax.random.randint)."""
    return T.randint(key, n, 0, f.n_owners)


def partition(seq: Sequence[int], cap: Optional[int] = None) -> List[Tuple[int, int]]:
    """Greedy maximal runs of distinct owners, each at most `cap` long."""
    groups, start, seen = [], 0, set()
    for k, o in enumerate(seq):
        if o in seen or (cap is not None and k - start >= cap):
            groups.append((start, k - start))
            start, seen = k, {o}
        else:
            seen.add(o)
    if len(seq) > start:
        groups.append((start, len(seq) - start))
    return groups


def auto_cap(seq: Sequence[int], overhead: float = 4.0, limit: int = 16) -> int:
    """The cap c in (1, 2, 3, 4, 6, 8, 12, 16), up to the longest run, that
    minimises groups(c) * (c + overhead); ties to the smaller."""
    if not len(seq):
        return 1
    longest = max(n for _, n in partition(seq))
    best, cost = 1, math.inf
    for c in (1, 2, 3, 4, 6, 8, 12, 16):
        if c > min(longest, limit):
            break
        v = len(partition(seq, c)) * (c + overhead)
        if v < cost:
            best, cost = c, v
    return best


def groups_for(seq: Sequence[int], f: FedSpec) -> List[Tuple[int, int]]:
    """The dispatch's groups: one round each under the sequential driver."""
    if f.driver == "sequential":
        return [(k, 1) for k in range(len(seq))]
    cap = auto_cap(seq) if f.max_group == "auto" else f.max_group
    return partition(seq, cap)


def granted(seqs: Sequence[Sequence[int]], f: FedSpec) -> Tuple[List[int], List[int]]:
    """(spent, refused) per owner after the dispatches `seqs` in order: a
    round is granted while its owner has answered fewer than T rounds."""
    spent, refused = [0] * f.n_owners, [0] * f.n_owners
    for seq in seqs:
        for o in seq:
            if spent[o] < f.horizon:
                spent[o] += 1
            else:
                refused[o] += 1
    return spent, refused


# ------------------------------ the round ------------------------------------
def clipped_sum(tb: torch.Tensor, tokens: torch.Tensor, labels: torch.Tensor,
                cfg: M.ModelSpec, f: FedSpec, half_batch: bool = False
                ) -> Tuple[torch.Tensor, List[float]]:
    """(sum over the G microbatches of the clipped gradient at tb, their
    gradient norms). `half_batch` is a planted fault: each microbatch's
    loss is taken over the first half of its rows only."""
    lay = M.layout(cfg)
    sizes = [math.prod(s) for _, s, _ in lay]
    G = f.microbatches
    rows = tokens.shape[0] // G
    acc = torch.zeros_like(tb)
    norms = []
    for g in range(G):
        tok, lab = tokens[g * rows:(g + 1) * rows], labels[g * rows:(g + 1) * rows]
        if half_batch:
            tok, lab = tok[:max(1, rows // 2)], lab[:max(1, rows // 2)]
        leaf = tb.detach().requires_grad_(True)
        p = {name: piece.view(shape) for (name, shape, _), piece
             in zip(lay, torch.split(leaf, sizes))}
        M.loss(p, tok, lab, cfg).backward()
        grad = leaf.grad
        norm = torch.sqrt(torch.sum(grad * grad))
        scale = torch.clamp(f.xi / torch.clamp(norm, min=1e-12), max=1.0)
        acc = acc + grad * scale
        norms.append(float(norm))
        del leaf, p, grad
    return acc, norms


def dp_update(tb: torch.Tensor, acc: torch.Tensor, key: torch.Tensor, owner: int,
              f: FedSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eq. 7 target, eq. 5 row) of one member, the noise drawn BLOCK
    elements at a time."""
    lr_own, lr_l = rates(f)
    dev = tb.device
    gain = torch.full((), 1.0 / f.microbatches, dtype=torch.float32, device=dev)
    ns = torch.full((), noise_scale(f), dtype=torch.float32, device=dev)
    n_i = torch.full((), float(f.records), dtype=torch.float32, device=dev)
    w = n_i / torch.full((), float(f.records * f.n_owners), dtype=torch.float32, device=dev)
    inv_2n = 1.0 / (2 * f.n_owners)
    new_l, new_i = torch.empty_like(tb), torch.empty_like(tb)
    for a in range(0, tb.numel(), BLOCK):
        b = min(a + BLOCK, tb.numel())
        t = tb[a:b]
        q = acc[a:b] * gain + ns * T.laplace_from_bits(T.bits(key, a, b))
        g_reg = f.sigma * t
        new_i[a:b] = torch.clamp(t - lr_own * (g_reg * inv_2n + w * q), -f.theta_max,
                                 f.theta_max)
        new_l[a:b] = torch.clamp(t - lr_l * g_reg, -f.theta_max, f.theta_max)
    return new_l, new_i


def implied_leaf_norms(acc: torch.Tensor, new_i: torch.Tensor, row: torch.Tensor,
                       f: FedSpec, sizes: Sequence[int]) -> Tuple[List[float], List[float]]:
    """(per-leaf norms of the reference's clipped-gradient sum `acc`, and of
    the sum that a judged row implies). Where the judged side's theta_bar
    and noise are the reference's, its eq. (5) row departs from the
    reference's `new_i` by -lr_own w_i (acc' - acc) / G, so its sum is
    acc' = acc + (new_i - row) G / (lr_own w_i), worked out in f64 leaf by
    leaf; a stale theta_bar or other noise shows in acc' as well."""
    lr_own, _ = rates(f)
    w = f.records / (f.records * f.n_owners)
    inv_c = f.microbatches / (lr_own * w)                 # 1 / (lr_own w_i / G)
    row = row.to(acc.device)
    ref, judged, off = [], [], 0
    for n in sizes:
        r2 = j2 = 0.0
        for a in range(off, off + n, BLOCK):
            b = min(a + BLOCK, off + n)
            acc64 = acc[a:b].double()
            imp = acc64 + (new_i[a:b].double() - row[a:b].double()) * inv_c
            r2 += float(torch.sum(acc64 * acc64))
            j2 += float(torch.sum(imp * imp))
        ref.append(math.sqrt(r2))
        judged.append(math.sqrt(j2))
        off += n
    return ref, judged


@dataclass
class Trajectory:
    """What the reference computed for a dispatch: the owners, each round's
    largest microbatch gradient norm, the state after it, and for each
    watched owner the per-leaf norms of its last round's clipped-gradient
    sum, the reference's and the one its judged row implies."""
    owners: List[int]
    max_grad_norms: List[float]
    theta_L: torch.Tensor
    rows: Dict[int, torch.Tensor]
    leaf_grads: Dict[int, List[float]]
    leaf_grads_judged: Dict[int, List[float]]


def run_dispatch(theta0: torch.Tensor, seq: Sequence[int], keys: torch.Tensor,
                 tokens: torch.Tensor, labels: torch.Tensor, cfg: M.ModelSpec, f: FedSpec,
                 half_batch: bool = False, stale_carry: bool = False,
                 watch: Optional[Dict[int, torch.Tensor]] = None) -> Trajectory:
    """The dispatch `seq` from a fresh state (theta_L and every owner's row
    equal to theta0; no owner has answered): round k with keys[k] and the
    batch tokens[k], labels[k]. Every round is granted (a fresh ledger and
    len(seq) <= T). `watch` maps owners to the judged side's row of each
    after the dispatch, whose implied gradient (`implied_leaf_norms`) is
    read at the owner's last round. `stale_carry` is a planted fault: each
    group reads theta_L and the rows as they were one group earlier."""
    watch = watch or {}
    sizes = [math.prod(s) for _, s, _ in M.layout(cfg)]
    last = {int(o): k for k, o in enumerate(seq)}
    theta_l = theta0.clone()
    rows: Dict[int, torch.Tensor] = {}
    mgn: List[float] = [0.0] * len(seq)
    leaf_ref: Dict[int, List[float]] = {}
    leaf_judged: Dict[int, List[float]] = {}
    stale = (theta_l, dict(rows))
    for start, n in groups_for(seq, f):
        members = range(start, start + n)
        src_l, src_rows = stale if stale_carry else (theta_l, rows)
        outs = []
        for k in members:
            o = int(seq[k])
            theta_i = src_rows.get(o, theta0)
            tb = 0.5 * (src_l + theta_i)
            acc, norms = clipped_sum(tb, tokens[k], labels[k], cfg, f, half_batch)
            mgn[k] = max(norms)
            outs.append((o, *dp_update(tb, acc, keys[k], o, f)))
            if o in watch and last[o] == k:
                leaf_ref[o], leaf_judged[o] = implied_leaf_norms(acc, outs[-1][2], watch[o],
                                                                 f, sizes)
            del tb, acc
        if stale_carry:
            stale = (theta_l, dict(rows))
        for o, _, new_i in outs:
            rows[o] = new_i
        if n == 1:
            theta_l = outs[0][1]
        else:
            stacked = torch.stack([new_l for _, new_l, _ in outs])
            ok = torch.ones(n, dtype=torch.bool, device=theta0.device)
            s = torch.sum(torch.where(ok[:, None], stacked, 0.0), dim=0)
            theta_l = s / torch.clamp(torch.sum(ok, dtype=torch.float32), min=1.0)
            del stacked
        del outs
    return Trajectory([int(o) for o in seq], mgn, theta_l, rows, leaf_ref, leaf_judged)


def leaf_change_norms(buf: torch.Tensor, base: torch.Tensor, sizes: Sequence[int]
                      ) -> List[float]:
    """||buf - base|| over each leaf's slice of two packed (P,) buffers."""
    out, off = [], 0
    for n in sizes:
        out.append(float(torch.linalg.vector_norm(buf[off:off + n] - base[off:off + n])))
        off += n
    return out
