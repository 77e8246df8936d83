"""DPC2xx — host syncs in the round loops.

The project-level half builds the set of functions reachable from the
port's round loops in federation/deep.py and federation/convex.py (the K
loop of each driver's `run`, the T loops of the convex engines; see
`dataflow.round_loops`), cross-module and factory-aware, and flags
anything in those loops and functions that makes the host wait for the
device:

    DPC201  .item(), .tolist(), .cpu(), .numpy(), np.asarray/np.array,
            float()/int()/bool() of a tensor, nonzero / argwhere /
            masked_select / unique / one-argument torch.where, boolean-
            mask indexing, torch.cuda.synchronize
    DPC202  a python `if`/`while`/`x if c else y` on a tensor
    DPC203  print of a tensor

A round loop with any of these cannot run ahead of the card, and a CUDA
graph capture of a K-round dispatch breaks on it. Taint (= "a tensor") is
deliberately narrow, as in the reference: results of torch.* calls, of
methods of tainted values, and arithmetic on them. Shape, dtype and device
reads (`x.shape`, `x.numel()`, `x.device.type`) are host metadata, not
tensors. Parameters are NOT tainted, so static-config dispatch
(`if cfg.fused_kernel:`) stays legal. A branch taken only on the CPU
(`if x.device.type == "cpu":`) runs the plain versions, where there is
no device to wait for, and is not checked. Set-up syncs (the session's one
host copy of a dispatch's owner sequence, `device_free_bytes`) run before
the loops and are not reachable from them.

The file-level half (DPC204) catches the bench/example hot-loop pattern
`int(owner_seq[i])` — a blocking transfer per iteration inside a python
for/while — anywhere, not just in round-reachable code. String-literal
subscripts (metric dicts) and names rebound to host values (np.asarray,
`.tolist()`, `.numpy()`) are exempt.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.dpcheck.core import FileCtx, Violation
from repro_torch.analysis.dpcheck.dataflow import (FuncDef, ModuleIndex, assigned_names,
                                                   call_name, callees, method_name,
                                                   reachable_functions, round_loops)

ROOT_MODULES = ("repro_torch.federation.deep", "repro_torch.federation.convex")

# host metadata of a tensor: reading it never waits for the device
METADATA_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
                  "requires_grad", "type", "index", "grad_fn", "names"}
METADATA_METHODS = {"numel", "dim", "size", "stride", "element_size",
                    "data_ptr", "is_contiguous", "get_device", "nelement",
                    "storage_offset", "is_floating_point", "is_complex"}
# torch calls that return host values, not tensors
HOST_TORCH_CALLS = {"torch.device", "torch.Size", "torch.finfo", "torch.iinfo",
                    "torch.is_tensor", "torch.get_default_dtype",
                    "torch.cuda.is_available", "torch.cuda.device_count",
                    "torch.is_floating_point"}
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
NP_SYNCS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
SYNC_CALLS = {"torch.nonzero", "torch.argwhere", "torch.masked_select",
              "torch.unique", "torch.cuda.synchronize"}
SYNC_METHODS = {"nonzero", "argwhere", "masked_select", "unique"}
BOOL_CALLS = {"torch.isfinite", "torch.isnan", "torch.isinf", "torch.logical_and",
              "torch.logical_or", "torch.logical_not", "torch.eq", "torch.ne",
              "torch.gt", "torch.lt", "torch.ge", "torch.le"}


def _is_torch_call(name: str) -> bool:
    return name.split(".")[0] == "torch" and name not in HOST_TORCH_CALLS


class _Taint:
    """Names bound to tensors (torch results and values derived from them)
    in one function, and which of them are boolean masks."""

    def __init__(self) -> None:
        self.tainted: Set[str] = set()
        self.masks: Set[str] = set()

    def is_tainted(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Call):
            name = call_name(e)
            if name and _is_torch_call(name):
                return True
            meth = method_name(e)
            return (meth is not None and meth not in METADATA_METHODS
                    and meth not in HOST_METHODS and self.is_tainted(e.func.value))
        if isinstance(e, ast.Attribute):
            return e.attr not in METADATA_ATTRS and self.is_tainted(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tainted(e.left) or self.is_tainted(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tainted(e.operand)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return False            # identity, not a tensor comparison
            return (self.is_tainted(e.left)
                    or any(self.is_tainted(c) for c in e.comparators))
        if isinstance(e, ast.Subscript):
            return self.is_tainted(e.value)
        if isinstance(e, ast.BoolOp):
            return any(self.is_tainted(v) for v in e.values)
        return False

    def is_mask(self, e: ast.AST) -> bool:
        """A boolean tensor: a tensor comparison, a torch predicate, `~`,
        `&`, `|` of masks, `.to(torch.bool)`, or a name bound to one."""
        if isinstance(e, ast.Name):
            return e.id in self.masks
        if isinstance(e, ast.Compare):
            return self.is_tainted(e)
        if isinstance(e, ast.Call):
            if call_name(e) in BOOL_CALLS:
                return True
            return (method_name(e) == "to" and e.args
                    and (ast.unparse(e.args[0]) in ("torch.bool", "bool")))
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, (ast.Invert, ast.Not)):
            return self.is_mask(e.operand)
        if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitAnd, ast.BitOr,
                                                          ast.BitXor)):
            return self.is_mask(e.left) or self.is_mask(e.right)
        return False

    def bind(self, s: ast.stmt) -> None:
        if isinstance(s, ast.Assign):
            targets, value = s.targets, s.value
        elif isinstance(s, ast.AnnAssign) and s.value is not None:
            targets, value = [s.target], s.value
        else:
            return
        names = [n for t in targets for n in assigned_names(t)]
        if self.is_tainted(value):
            self.tainted.update(names)
        if self.is_mask(value):
            self.masks.update(names)


def _cpu_only(test: ast.AST) -> bool:
    """`<x>.device.type == "cpu"`: a branch that runs on the CPU only."""
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)
            and isinstance(test.left, ast.Attribute) and test.left.attr == "type"
            and isinstance(test.left.value, ast.Attribute)
            and test.left.value.attr == "device"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == "cpu")


def _statements(stmts):
    """Walk statements, nested blocks included, without descending into
    nested defs (their own reachability) or CPU-only branches."""
    todo = list(stmts)
    while todo:
        s = todo.pop(0)
        if isinstance(s, FuncDef + (ast.ClassDef,)):
            continue
        yield s
        if isinstance(s, ast.If) and _cpu_only(s.test):
            todo.extend(s.orelse)
            continue
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.stmt):
                todo.append(child)
            elif isinstance(child, ast.excepthandler):
                todo.extend(child.body)


def _exprs(s: ast.stmt):
    """The expression nodes a statement evaluates itself (not those of the
    statements nested in it), lambdas included."""
    for child in ast.iter_child_nodes(s):
        if isinstance(child, (ast.stmt, ast.excepthandler)):
            continue
        yield from ast.walk(child)


def _check_statements(ctx: FileCtx, qual: str, fn: ast.AST, stmts) -> List[Violation]:
    taint = _Taint()
    for s in _statements(fn.body):
        taint.bind(s)
    where = f"in `{qual}` (reachable from a round loop)"
    out: List[Violation] = []

    def v(rule, node, msg):
        out.append(Violation(rule, ctx.rel, node.lineno, f"{msg} {where}"))

    for s in _statements(stmts):
        if isinstance(s, (ast.If, ast.While)) and taint.is_tainted(s.test):
            v("DPC202", s, "python branch on a tensor value — use torch.where")
        for node in _exprs(s):
            if isinstance(node, ast.IfExp) and taint.is_tainted(node.test):
                v("DPC202", node, "python conditional on a tensor value — use torch.where")
            if isinstance(node, ast.Subscript) and (
                    taint.is_mask(node.slice)
                    or (isinstance(node.slice, ast.Tuple)
                        and any(taint.is_mask(e) for e in node.slice.elts))):
                v("DPC201", node, "boolean-mask indexing syncs with the host")
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            meth = method_name(node)
            if meth in HOST_METHODS:
                v("DPC201", node, f".{meth}() host sync")
            elif name in NP_SYNCS:
                v("DPC201", node, f"{name} forces a device->host transfer")
            elif name in ("float", "int", "bool") and node.args and \
                    taint.is_tainted(node.args[0]):
                v("DPC201", node, f"{name}() on a tensor value")
            elif name in SYNC_CALLS or (meth in SYNC_METHODS and not name.startswith("torch.")
                                        and taint.is_tainted(node.func.value)):
                v("DPC201", node, f"{name or meth} waits for the device")
            elif name == "torch.where" and len(node.args) == 1 and not node.keywords:
                v("DPC201", node, "one-argument torch.where (nonzero) waits for the device")
            elif name == "print" and (
                    any(taint.is_tainted(a) for a in node.args)
                    or any(isinstance(a, ast.JoinedStr) and any(
                        isinstance(f, ast.FormattedValue) and taint.is_tainted(f.value)
                        for f in a.values) for a in node.args)):
                v("DPC203", node, "print of a tensor (private) value")
    return out


def check_project(ctxs: List[FileCtx], root: str) -> List[Violation]:
    indexes: Dict[str, ModuleIndex] = {
        c.module: ModuleIndex(c.module, c.tree) for c in ctxs}
    by_module = {c.module: c for c in ctxs}
    loops: List[Tuple[str, str, ast.AST]] = []
    roots = set()
    for mod in ROOT_MODULES:
        if mod not in indexes:
            continue
        for qual, loop in round_loops(indexes[mod]):
            loops.append((mod, qual, loop))
            body = [n for s in loop.body for n in [s, *ast.walk(s)]]
            roots |= callees(indexes, mod, qual, body)
    out: List[Violation] = []
    for mod, qual, loop in loops:
        out.extend(_check_statements(by_module[mod], qual, indexes[mod].functions[qual],
                                     loop.body))
    for module, qual in sorted(reachable_functions(indexes, roots)):
        fn = indexes[module].functions[qual]
        out.extend(_check_statements(by_module[module], qual, fn, fn.body))
    return out


_SYNC_CASTS = ("int", "float")
_HOST_BINDERS = ("np.asarray", "numpy.asarray", "np.array", "numpy.array",
                 "list", "range")


def check_file_loops(ctx: FileCtx) -> List[Violation]:
    """DPC204 — per-element host sync inside a python hot loop."""
    out: List[Violation] = []
    tensor_names: Set[str] = set()
    host_names: Set[str] = set()
    # names visible to the loop: any assignment in the enclosing module
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            cname = call_name(node.value)
            names = [n for t in node.targets for n in assigned_names(t)]
            if cname in _HOST_BINDERS or method_name(node.value) in HOST_METHODS:
                host_names.update(names)
            elif "." in cname:
                tensor_names.update(names)
    for loop in ast.walk(ctx.tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        for node in ast.walk(loop):
            sub = None
            kind = None
            if (isinstance(node, ast.Call)
                    and call_name(node) in _SYNC_CASTS and node.args
                    and isinstance(node.args[0], ast.Subscript)):
                sub, kind = node.args[0], call_name(node)
            elif (isinstance(node, ast.Call)
                  and method_name(node) == "item"
                  and isinstance(node.func.value, ast.Subscript)):
                sub, kind = node.func.value, ".item()"
            if sub is None or not isinstance(sub.value, ast.Name):
                continue
            idx = sub.slice
            if isinstance(idx, ast.Constant) and isinstance(idx.value, str):
                continue                # metric-dict lookup, not an array
            name = sub.value.id
            if name in host_names or name not in tensor_names:
                continue
            out.append(Violation(
                "DPC204", ctx.rel, node.lineno,
                f"{kind} on `{name}[...]` inside a python loop — one "
                "blocking device->host sync per iteration; hoist with "
                ".tolist() or .cpu().numpy() before the loop"))
    return out
