"""DPC3xx — DP-order invariants.

DPC301 (clip dominates noise): in any function that both clips and adds
mechanism noise, the clip must come first on every path. Clip markers are
calls whose name mentions ``clip`` (``_clip_scale``,
``_flat_clipped_grad_acc``; not torch.clip/np.clip) and the inline
``torch.minimum(1, xi / ...)`` clip-factor pattern; ``torch.clamp`` is the
theta_max projection, not sensitivity enforcement, and does not count. A
nested def containing a clip marker counts at its def site (the closure
runs inside the round). Noise markers are the mechanism entry points: the
kernel entry points that draw in-kernel (``dp_round_flat``,
``scale_noise``, ``tree_delta_``, ...), ``laplace_noise_tree`` and
``random.laplace`` / ``random.normal``. Functions with only one of the
two families are skipped — convex owners bound sensitivity analytically
and never clip, which is lawful.

DPC302 (grant masks the bank write): in a function that consults the
ledger (``.authorized(``), every bank-write call (``_write_bank``,
``_write_bank_rows``, ``_quant_write``, ``_write_rows_``,
``spmd.put_rows_``) must be refusal-masked: either it takes an ``ok=``
(``respond=``, ``granted=``) keyword or its value arguments are derived
from the grant mask (``torch.where``/``_select`` on it). An unmasked write
would let a refused round mutate owner state, voiding the budget
accounting. The fault layer's masks are grant sources too:
``verify_row(...)`` / ``finite_guard(...)`` / ``deadline_guard(...)``
results and the quarantine flags (``.quarantined`` reads), and so is the
hit bit of a paged bank's residency lookup (``slot, hit =
_bank_slot(bank, i)`` or ``bank.lookup(i)``; the slot vouches for
nothing).
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.dpcheck.core import FileCtx, Violation
from repro_torch.analysis.dpcheck.dataflow import (assigned_names, call_name,
                                             iter_functions)

NOISE_MARKERS = {
    "random.laplace", "random.normal", "laplace_noise_tree",
    "dp_round_flat", "dp_round_rows", "scale_noise", "fused_scale_noise_tree",
    "dp_privatize_tree", "tree_delta_", "tree_delta_rows_", "tree_delta_row",
}
BANK_WRITERS = ("_write_bank", "_write_bank_rows", "_quant_write", "_write_rows_",
                "put_rows_")
MASK_KWARGS = ("ok", "respond", "granted")


def _is_clip_call(call: ast.Call) -> bool:
    name = call_name(call)
    if not name:
        return False
    last = name.split(".")[-1]
    if name in ("torch.clip", "torch.clamp", "np.clip"):
        return False
    if "clip" in last.lower():
        return True
    # torch.minimum(1, xi / max(norm, eps)) — the clip-factor idiom
    if name == "torch.minimum" and call.args:
        a0 = call.args[0]
        return isinstance(a0, ast.Constant) and a0.value == 1
    return False


def _is_noise_call(call: ast.Call) -> bool:
    name = call_name(call)
    return bool(name) and (name in NOISE_MARKERS
                           or name.split(".")[-1] in NOISE_MARKERS
                           or ".".join(name.split(".")[-2:]) in NOISE_MARKERS)


def _stmt_markers(s: ast.stmt) -> Set[str]:
    """{'clip'}/{'noise'} markers contained in one statement."""
    out: Set[str] = set()
    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
        # closure defined here, executed later: its clip counts at def site
        for node in ast.walk(s):
            if isinstance(node, ast.Call) and _is_clip_call(node):
                out.add("clip")
        return out
    for node in ast.walk(s):
        if isinstance(node, ast.Call):
            if _is_clip_call(node):
                out.add("clip")
            if _is_noise_call(node):
                out.add("noise")
    return out


class _OrderWalker:
    """Linear walk; flags noise seen on a path with no prior clip."""

    def __init__(self, ctx: FileCtx):
        self.ctx = ctx
        self.out: List[Violation] = []

    def block(self, stmts, clip_seen: bool) -> (bool, bool):
        """-> (clip_seen after block, path terminated)."""
        for s in stmts:
            if isinstance(s, (ast.Return, ast.Raise)):
                clip_seen = self.stmt(s, clip_seen)
                return clip_seen, True
            if isinstance(s, ast.If):
                c1, d1 = self.block(s.body, clip_seen)
                c2, d2 = self.block(s.orelse, clip_seen)
                if d1 and not d2:
                    clip_seen = c2
                elif d2 and not d1:
                    clip_seen = c1
                else:
                    clip_seen = c1 and c2
                continue
            if isinstance(s, (ast.For, ast.While, ast.With, ast.Try)):
                inner = list(getattr(s, "body", []))
                for h in getattr(s, "handlers", []):
                    inner.extend(h.body)
                inner.extend(getattr(s, "orelse", []))
                inner.extend(getattr(s, "finalbody", []))
                clip_seen, _ = self.block(inner, clip_seen)
                continue
            clip_seen = self.stmt(s, clip_seen)
        return clip_seen, False

    def stmt(self, s: ast.stmt, clip_seen: bool) -> bool:
        markers = _stmt_markers(s)
        if "noise" in markers and not clip_seen and "clip" not in markers:
            self.pending.append(s.lineno)
        return clip_seen or "clip" in markers

    def check(self, qual: str, fn: ast.AST) -> List[Violation]:
        all_markers: Set[str] = set()
        for s in fn.body:
            all_markers |= _stmt_markers(s)
            for node in ast.walk(s):
                if isinstance(node, ast.stmt):
                    all_markers |= _stmt_markers(node)
        if not ("clip" in all_markers and "noise" in all_markers):
            return []
        self.pending: List[int] = []
        self.block(fn.body, False)
        return [Violation(
            "DPC301", self.ctx.rel, line,
            f"noise added in `{qual}` on a path where the clip step has "
            "not run — clipping must dominate the mechanism add")
            for line in self.pending]


# Calls whose result is a fault-layer guard mask: payload checksum
# verification, the non-finite update guard and the learner-deadline mask
# (an answered-late round is a lawful masked write-back exactly like a
# guard-rejected one).
GUARD_CALLS = ("verify_row", "finite_guard", "deadline_guard")


def _own_nodes(fn: ast.AST):
    """Walk a def WITHOUT descending into nested defs: every nested def
    is checked as its own function (iter_functions yields it), so masks
    bound in one closure must not vouch for writes in a sibling."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


def _grant_masks(fn: ast.AST) -> Set[str]:
    """Names bound from grant/guard sources and names derived from them.

    Sources: `.authorized(...)` ledger reads, `verify_row(...)` /
    `finite_guard(...)` fault guards, `.quarantined` flag reads, and the
    HIT bit of a page-residency lookup (`slot, hit = bank.lookup(i)` —
    paged-bank writes masked on residency are lawful no-ops for
    non-resident rows; the slot index itself vouches for nothing)."""
    masks: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Assign):
                continue
            # residency lookup: ONLY the second target of the 2-name
            # unpack becomes a mask — `slot` must never launder a write
            if (isinstance(node.value, ast.Call)
                    and ((call_name(node.value) or "").endswith(".lookup")
                         or call_name(node.value) == "_bank_slot")
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Tuple)
                    and len(node.targets[0].elts) == 2
                    and isinstance(node.targets[0].elts[1], ast.Name)):
                hit = node.targets[0].elts[1].id
                if hit not in masks:
                    masks.add(hit)
                    changed = True
                continue
            derived = False
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Call):
                    name = call_name(sub)
                    if (name.endswith(".authorized")
                            or name.split(".")[-1] in GUARD_CALLS):
                        derived = True
                if isinstance(sub, ast.Attribute) and \
                        sub.attr == "quarantined":
                    derived = True
                if isinstance(sub, ast.Name) and sub.id in masks:
                    derived = True
            if derived:
                for t in node.targets:
                    for n in assigned_names(t):
                        if n not in masks:
                            masks.add(n)
                            changed = True
    return masks


def _check_bank_writes(ctx: FileCtx, qual: str,
                       fn: ast.AST) -> List[Violation]:
    masks = _grant_masks(fn)
    if not masks:
        return []
    out: List[Violation] = []
    for node in _own_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        last = name.split(".")[-1]
        if last not in BANK_WRITERS:
            continue
        if any(kw.arg in MASK_KWARGS for kw in node.keywords):
            continue
        uses_mask = any(isinstance(sub, ast.Name) and sub.id in masks
                        for a in node.args for sub in ast.walk(a))
        if not uses_mask:
            out.append(Violation(
                "DPC302", ctx.rel, node.lineno,
                f"bank write `{last}` in `{qual}` is not masked by the "
                "ledger grant — refused rounds must be bit-exact no-ops"))
    return out


def check_file(ctx: FileCtx) -> List[Violation]:
    out: List[Violation] = []
    for qual, fn in iter_functions(ctx.tree):
        out.extend(_OrderWalker(ctx).check(qual, fn))
        out.extend(_check_bank_writes(ctx, qual, fn))
    return out
