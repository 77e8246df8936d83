"""The comparison that decides `correct`: what the program's timed call
produced against the plain reference, number by number, each beside its
limit (the cell's `bench/limits/<cell>.json`).

  owner_mismatch   rounds whose owner differs: the schedule's draw of every
                   dispatch of the run and the owners the checked dispatch
                   reports, against the reference's threefry draw (exact).
  ledger_mismatch  owners whose device ledger (spent, refused) after the
                   run differs from the reference's count of the rounds it
                   dispatched (exact).
  grad_norm_gap    over the checked dispatch's rounds, the largest
                   |program - reference| / reference of the round's largest
                   microbatch gradient norm (the model's loss gradient,
                   before clipping, as `run_rounds` reports it).
  grad_leaf_gap    for a sample of the checked dispatch's owners (drawn
                   from the seed), the gradient of each one's last round,
                   leaf by leaf: the clipped-gradient sum its row implies
                   (`reference.federation.implied_leaf_norms`) against the
                   reference's, the largest |program - reference| of a
                   leaf's norm over the larger of the reference's norm of
                   that leaf and of the median leaf. Leaves whose reference
                   gradient is under a thousandth of the median leaf's
                   (nought to rounding, as a key's bias under softmax) are
                   left out.
  update_leaves_off  after the checked dispatch, the leaves of theta_L and
                   of every row it wrote whose change from the initial
                   weights, as a norm, is off the reference's by more than
                   the cell's `update_tolerance` of the larger of the
                   reference's norm of that leaf and of the median leaf: the
                   Laplace draw, the clip and the updates (5) and (7) (exact
                   count; a leaf left unmoved, moved double or noised with
                   another key is off).

The Laplace noise is about 1e4 times the clipped gradient in a round's
change, so the change of a leaf tells the update apart, not the gradient:
a sound run's leaves differ from the reference's by a rounding flip of one
element at most (a few 1e-9 of a small leaf's change norm), a gradient
computed in TF32 by some 1e-8, a fault by 1e-4 (another key's noise) to 1
(a leaf unmoved). `grad_norm_gap` and `grad_leaf_gap` tell the gradient
apart: the first as a whole, the second leaf by leaf.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

NAMES = ("owner_mismatch", "ledger_mismatch", "grad_norm_gap", "grad_leaf_gap",
         "update_leaves_off")
LEAF_FLOOR = 1e-3      # leaves under this share of the median leaf's gradient are left out


def _leaves_off(prog: Sequence[float], ref: Sequence[float], tol: float) -> int:
    floor = statistics.median(ref)
    return sum(not abs(a - b) <= tol * max(b, floor) for a, b in zip(prog, ref))


def _worst(gaps) -> float:
    """The largest gap, or inf if any is not finite (a NaN compares as
    neither larger nor smaller, so max() alone could pass over it)."""
    gaps = list(gaps)
    return math.inf if not all(math.isfinite(g) for g in gaps) else max(gaps, default=0.0)


def _leaf_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    floor = statistics.median(ref)
    return _worst(abs(a - b) / max(b, floor) for a, b in zip(prog, ref)
                  if b >= LEAF_FLOOR * floor)


def numbers(prog: dict, ref: dict, update_tolerance: float) -> Dict[str, float]:
    """Each compared number of a run. `prog` and `ref` hold `seqs` (every
    drawn owner, in order), `check_owners`, `max_grad_norms`, `leaf_grads`
    ({owner: per-leaf gradient norms}), `spent`, `refused` and `changes`
    ({"theta_L" or an owner: per-leaf norms}); a leaf is off by more than
    `update_tolerance` (relative)."""
    seq_p, seq_r = list(prog["seqs"]), list(ref["seqs"])
    owners = sum(a != b for a, b in zip(seq_p, seq_r)) + abs(len(seq_p) - len(seq_r))
    owners += sum(a != b for a, b in zip(prog["check_owners"], ref["check_owners"]))
    ledger = sum((a, b) != (c, d) for a, b, c, d in zip(prog["spent"], prog["refused"],
                                                       ref["spent"], ref["refused"]))
    grad = _worst(abs(a - b) / max(b, 1e-30)
                  for a, b in zip(prog["max_grad_norms"], ref["max_grad_norms"]))
    leaf = _worst(_leaf_gap(prog["leaf_grads"][o], norms) if o in prog["leaf_grads"]
                  else math.inf for o, norms in ref["leaf_grads"].items()) \
        if ref["leaf_grads"] else math.inf
    off = 0
    for name, norms in ref["changes"].items():
        got = prog["changes"].get(name)
        off += len(norms) if got is None else _leaves_off(got, norms, update_tolerance)
    return {"owner_mismatch": float(owners), "ledger_mismatch": float(ledger),
            "grad_norm_gap": grad, "grad_leaf_gap": leaf, "update_leaves_off": float(off)}


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """(every number within its limit, one line per number)."""
    lines = [f"check {n} {nums[n]!r} limit {limits[n]!r}" for n in NAMES]
    return all(nums[n] <= limits[n] for n in NAMES), lines
