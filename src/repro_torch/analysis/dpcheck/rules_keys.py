"""DPC1xx — PRNG key discipline.

Intraprocedural abstract interpretation of the port's key values (the
reference's rules on ``repro_torch.random``). Each local name that ever
receives a key gets a state:

    FRESH    assigned from PRNGKey/fold_in/split-result/subscript/param
    CONSUMED a known sampler drew from it
    SPLIT    random.split read it without rebinding it
    ESCAPED  passed to an opaque call (ownership now shared)

Transitions that indicate reuse of threefry state are violations:

    DPC101  sampler(k) with k CONSUMED        (two draws, same stream)
    DPC102  random.*(k) with k SPLIT          (parent reused after split)
    DPC103  PRNGKey(<literal>) in src/repro_torch/ (constant seed in library)
    DPC104  sampler key arg is an opaque Call (derivation not visible)
    DPC105  random use of an ESCAPED key, or a second escape

The samplers are ``random.bits``, ``bits_range``, ``bits_block``,
``randint``, ``uniform``, ``laplace``, ``normal``, ``exponential`` and
``gumbel``, and the kernel entry points that hash their key in-kernel
(`KERNEL_SAMPLERS`, each with the position of its key argument): on the
card no ``random`` call happens for their draw, so they are samplers in
their own right. Branches of an `if` are merged pessimistically (worst
state wins); `for`/`while` bodies are interpreted twice so a loop-invariant
key consumed each iteration trips DPC101 on the second pass.
"""
from __future__ import annotations

import ast
import collections
from typing import Dict, List, Optional

from repro_torch.analysis.dpcheck.core import FileCtx, Violation
from repro_torch.analysis.dpcheck.dataflow import (assigned_names, call_name,
                                             iter_functions, param_names)

SAMPLERS = {
    "bits", "bits_range", "bits_block", "randint", "uniform", "laplace",
    "normal", "exponential", "gumbel",
}
DERIVERS = {"split", "fold_in", "PRNGKey"}

# kernel entry points that draw from their key in-kernel -> the position of
# the key argument (also accepted as key=/keys=)
KERNEL_SAMPLERS = {
    "dp_round_flat": 2, "dp_round_rows": 2, "scale_noise": 1,
    "tree_delta_": 3, "tree_delta_rows_": 3, "encode_row": 1,
    "fused_scale_noise_tree": 1, "dp_privatize_tree": 1, "tree_delta_row": 2,
}

# methods that move or view a key without deriving a new one
KEY_VIEWS = {"to", "contiguous", "reshape", "view", "clone", "detach", "cuda", "cpu"}

FRESH, CONSUMED, SPLIT, ESCAPED = "fresh", "consumed", "split", "escaped"
_RANK = {FRESH: 0, CONSUMED: 1, SPLIT: 2, ESCAPED: 3}

# calls that read a value without taking ownership of it — not escapes
NEUTRAL_CALLS = {
    "isinstance", "len", "print", "str", "repr", "type", "getattr",
    "hasattr", "id", "hash", "zip", "enumerate", "list", "tuple", "sorted",
    "format", "min", "max", "sum", "abs", "range", "torch.as_tensor",
    "np.asarray", "torch.stack", "torch.tensor",
}


def _keyish(name: str) -> bool:
    # `K`, upper case, is the port's round count, not a key
    return "key" in name.lower() or name in ("k", "rng", "nk", "ks", "subkey")


def _rand_fn(call: ast.Call) -> Optional[str]:
    """'split' for random.split(...) / repro_torch.random.split(...), else
    None."""
    name = call_name(call)
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] == "random" and (
            len(parts) == 2 or parts[-3] == "repro_torch"):
        return parts[-1]
    return None


def _kernel_fn(call: ast.Call) -> Optional[str]:
    """The kernel entry point a call names (bare or dotted), else None."""
    last = call_name(call).split(".")[-1]
    return last if last in KERNEL_SAMPLERS else None


class _FnChecker:
    def __init__(self, ctx: FileCtx, fn: ast.AST):
        self.ctx = ctx
        self.fn = fn
        self.out: List[Violation] = []
        self.state: Dict[str, str] = {p: FRESH for p in param_names(fn)
                                      if _keyish(p)}

    def emit(self, rule: str, node: ast.AST, msg: str) -> None:
        self.out.append(Violation(rule, self.ctx.rel, node.lineno, msg))

    # -- statement walk -------------------------------------------------
    def run(self) -> List[Violation]:
        self.block(self.fn.body)
        return self.out

    def block(self, stmts: List[ast.stmt]) -> bool:
        """Interpret a statement list; True if it terminates the path."""
        for s in stmts:
            if isinstance(s, (ast.Return, ast.Raise, ast.Break,
                              ast.Continue)):
                self.stmt(s)
                return True
            self.stmt(s)
        return False

    def stmt(self, s: ast.stmt) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return                      # nested defs get their own pass
        if isinstance(s, ast.If):
            before = dict(self.state)
            self.expr(s.test)
            body_done = self.block(s.body)
            after_body = self.state
            self.state = dict(before)
            else_done = self.block(s.orelse)
            # a branch that returned/raised contributes nothing downstream
            if body_done and not else_done:
                return                  # keep else-state
            if else_done and not body_done:
                self.state = after_body
                return
            merged = dict(self.state)
            for k, v in after_body.items():
                cur = merged.get(k, FRESH)
                merged[k] = v if _RANK[v] > _RANK[cur] else cur
            self.state = merged
            return
        if isinstance(s, (ast.For, ast.While)):
            loop_targets = (assigned_names(s.target)
                            if isinstance(s, ast.For) else [])
            key_iter = False
            if isinstance(s, ast.For):
                self.expr(s.iter)
                iter_names = {n.id for n in ast.walk(s.iter)
                              if isinstance(n, ast.Name)}
                key_iter = bool(iter_names & set(self.state)) or any(
                    isinstance(n, ast.Call) and _rand_fn(n) in DERIVERS
                    for n in ast.walk(s.iter))
            for _ in range(2):          # 2nd pass: loop-carried reuse
                for t in loop_targets:  # loop var rebinds every iteration
                    if t in self.state or (key_iter and _keyish(t)):
                        self.state[t] = FRESH
                self.block(s.body)
            self.block(s.orelse)
            return
        if isinstance(s, (ast.Try,)):
            self.block(s.body)
            for h in s.handlers:
                self.block(h.body)
            self.block(s.orelse)
            self.block(s.finalbody)
            return
        if isinstance(s, (ast.With,)):
            self.block(s.body)
            return
        # ordinary statement: evaluate RHS calls left-to-right, then binds
        targets: List[str] = []
        if isinstance(s, ast.Assign):
            for t in s.targets:
                targets.extend(assigned_names(t))
            self.expr(s.value)
        elif isinstance(s, ast.AugAssign):
            self.expr(s.value)
        elif isinstance(s, (ast.Expr, ast.Return)) and s.value is not None:
            self.expr(s.value)
        elif isinstance(s, ast.AnnAssign) and s.value is not None:
            targets.extend(assigned_names(s.target))
            self.expr(s.value)
        # rebinding a name gives it a fresh identity (key, sub = split(key))
        value = getattr(s, "value", None)
        derives = (isinstance(value, ast.Call)
                   and _rand_fn(value) in DERIVERS)
        key_subscript = (isinstance(value, ast.Subscript)
                         and isinstance(value.value, ast.Name)
                         and (value.value.id in self.state
                              or _keyish(value.value.id)))
        for t in targets:
            if derives or (key_subscript and (_keyish(t)
                                              or len(targets) == 1)):
                self.state[t] = FRESH   # fresh key identity
            elif t in self.state:
                del self.state[t]       # rebound to a non-key value

    def expr(self, e: ast.AST) -> None:
        # calls in ast.walk's breadth-first order, as the reference's; an
        # `a if c else b` runs one branch: fork there, then merge the worst
        todo = collections.deque([e])
        while todo:
            node = todo.popleft()
            if isinstance(node, ast.IfExp):
                self.expr(node.test)
                before = dict(self.state)
                self.expr(node.body)
                after_body, self.state = self.state, before
                self.expr(node.orelse)
                for k, v in after_body.items():
                    cur = self.state.get(k, FRESH)
                    self.state[k] = v if _RANK[v] > _RANK[cur] else cur
                continue
            if isinstance(node, ast.Call):
                self.call(node)
            todo.extend(ast.iter_child_nodes(node))

    # -- call transition ------------------------------------------------
    def call(self, call: ast.Call) -> None:
        kfn = _kernel_fn(call)
        if kfn is not None:
            pos = KERNEL_SAMPLERS[kfn]
            if len(call.args) > pos:
                self.key_arg(call, call.args[pos], kfn)
            for kw in call.keywords:
                if kw.arg in ("key", "keys"):
                    self.key_arg(call, kw.value, kfn)
            return
        fn = _rand_fn(call)
        if fn == "PRNGKey":
            if (self.ctx.is_library and call.args
                    and isinstance(call.args[0], ast.Constant)):
                self.emit("DPC103", call,
                          f"random.{fn}({call.args[0].value!r}) — "
                          "constant seed in library code; thread a key in")
            return
        if fn == "fold_in":
            return                      # derives; does not consume
        if fn == "split":
            if call.args and isinstance(call.args[0], ast.Name):
                name = call.args[0].id
                st = self.state.get(name)
                if st == ESCAPED:
                    self.emit("DPC105", call,
                              f"key `{name}` split after escaping to a "
                              "helper — ownership is ambiguous")
                self.state[name] = SPLIT
            return
        if fn in SAMPLERS:
            if call.args:
                self.key_arg(call, call.args[0], fn)
            for kw in call.keywords:
                if kw.arg == "key":
                    self.key_arg(call, kw.value, fn)
            return
        if fn is not None:
            # other random op on a tracked name: treat as a read
            for a in call.args:
                if isinstance(a, ast.Name) and self.state.get(a.id) == SPLIT:
                    self.emit("DPC102", call,
                              f"key `{a.id}` used by random.{fn} "
                              "after being split")
            return
        # opaque call: any tracked key passed through escapes
        cname = call_name(call)
        if cname in NEUTRAL_CALLS or cname.split(".")[-1] in ("append",
                                                              "get"):
            return
        for a in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(a, ast.Name) and a.id in self.state:
                st = self.state[a.id]
                if st == ESCAPED:
                    self.emit("DPC105", call,
                              f"key `{a.id}` passed to a second helper "
                              f"({call_name(call) or '<call>'}) — two "
                              "callees may draw from the same stream")
                elif st in (CONSUMED, SPLIT):
                    pass                # already flagged if re-drawn
                else:
                    self.state[a.id] = ESCAPED

    def key_arg(self, call: ast.Call, arg: ast.AST, sampler: str) -> None:
        while (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute)
               and arg.func.attr in KEY_VIEWS):
            arg = arg.func.value        # key.to(dev) carries the key itself
        if isinstance(arg, ast.Name):
            st = self.state.get(arg.id)
            if st == CONSUMED:
                self.emit("DPC101", call,
                          f"key `{arg.id}` consumed by a second sampler "
                          f"({sampler}) — same threefry stream "
                          "drawn twice")
            elif st == SPLIT:
                self.emit("DPC102", call,
                          f"key `{arg.id}` consumed by "
                          f"{sampler} after being split")
            elif st == ESCAPED:
                self.emit("DPC105", call,
                          f"key `{arg.id}` consumed by "
                          f"{sampler} after escaping to a helper")
            self.state[arg.id] = CONSUMED
        elif isinstance(arg, ast.Call):
            fn = _rand_fn(arg)
            if fn not in DERIVERS:
                self.emit("DPC104", call,
                          f"key argument of {sampler} is an "
                          "opaque call — derive keys via split/fold_in")


def check_file(ctx: FileCtx) -> List[Violation]:
    out: List[Violation] = []
    for _, fn in iter_functions(ctx.tree):
        out.extend(_FnChecker(ctx, fn).run())
    # module-level statements (scripts, examples)
    mod_fn = ast.Module(body=[s for s in ctx.tree.body
                              if not isinstance(s, (ast.FunctionDef,
                                                    ast.AsyncFunctionDef,
                                                    ast.ClassDef))],
                        type_ignores=[])
    mod_fn.args = ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                kw_defaults=[], defaults=[])
    checker = _FnChecker.__new__(_FnChecker)
    checker.ctx = ctx
    checker.fn = mod_fn
    checker.out = []
    checker.state = {}
    checker.block(mod_fn.body)
    out.extend(checker.out)
    return out
