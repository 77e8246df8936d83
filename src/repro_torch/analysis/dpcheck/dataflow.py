"""Shared AST plumbing for the dpcheck rules.

The reference's helpers (dotted-name resolution, per-module function
indexing with nested defs, import maps, the cross-module reachability
walk), with the port's root finder: the port has no ``lax.scan`` or
``fori_loop``; its K-round and T-step bodies are Python loops over device
tensors. `round_loops` finds them in the code: the outermost loops of a
root module's functions that index a sequence with their loop variable
(`owners[k:k + 1]`, `keys[k]`, `noise_t[k]`; `row[0]` of a group's row). Their
bodies, and every function they call, are what a round runs.

Calls are resolved beyond bare names: a name bound from a factory call
(``compute = _round_compute(...)``) in an enclosing scope denotes the
factory's nested defs, so ``compute.rows(...)`` lands on them; an
``a if c else b`` of such names denotes both; a function passed as an
argument is taken as called; ``obj.meth(...)`` on an unknown object lands
on the methods of that name of the classes the module defines or imports
from an analyzed module.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)
Loop = (ast.For, ast.AsyncFor, ast.While)
Target = Tuple[str, str]


def dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str:
    return dotted(call.func) or ""


def method_name(call: ast.Call) -> Optional[str]:
    """'item' for any `<expr>.item(...)`, whatever the receiver."""
    return call.func.attr if isinstance(call.func, ast.Attribute) else None


def assigned_names(target: ast.AST) -> List[str]:
    """Plain names bound by an assignment target (tuples unpacked)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in target.elts:
            out.extend(assigned_names(elt))
        return out
    return []


def iter_functions(tree: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """(qualname, node) for every def in the module, nested included."""
    def walk(node: ast.AST, prefix: str) -> Iterator[Tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, FuncDef):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from walk(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)
    yield from walk(tree, "")


def param_names(fn: ast.AST) -> Set[str]:
    a = fn.args
    names = [p.arg for p in
             a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def import_map(tree: ast.AST) -> Dict[str, str]:
    """local name -> fully qualified origin, for module-level imports."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}")
    return out


def own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Every node of a def (or a loop) except those inside nested defs and
    classes, which are functions of their own."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        if isinstance(node, FuncDef + (ast.ClassDef,)):
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


class ModuleIndex:
    """Per-module lookup tables used by the reachability walk."""

    def __init__(self, module: str, tree: ast.AST):
        self.module = module
        self.tree = tree
        self.functions: Dict[str, ast.AST] = dict(iter_functions(tree))
        self.imports = import_map(tree)
        self.classes = {n.name for n in tree.body if isinstance(n, ast.ClassDef)}
        # factory pattern:  compute = _round_compute(...)  where the factory
        # is a def whose `return` hands back one of its nested defs; its
        # other nested defs ride along as attributes (compute.rows = rows)
        self.factory_returns: Dict[str, str] = {}
        self.nested: Dict[str, List[str]] = {}
        for qual, fn in self.functions.items():
            self.nested[qual] = [f"{qual}.{n.name}" for n in fn.body
                                 if isinstance(n, FuncDef)]
            returned = self._returned_nested_def(qual, fn)
            if returned:
                self.factory_returns[qual] = returned
        self._bindings: Dict[str, Dict[str, List[ast.AST]]] = {}

    def _returned_nested_def(self, qual: str, fn: ast.AST) -> Optional[str]:
        nested = {n.name: f"{qual}.{n.name}" for n in fn.body
                  if isinstance(n, FuncDef)}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Return)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in nested):
                return nested[node.value.id]
        return None

    def resolve_local(self, name: str, scope: str) -> Optional[str]:
        """Resolve a bare called name to a qualname in this module.

        Searches innermost-out from `scope` (a qualname prefix), then
        module level.
        """
        parts = scope.split(".") if scope else []
        while True:
            cand = ".".join(parts + [name]) if parts else name
            if cand in self.functions:
                return cand
            if not parts:
                return None
            parts.pop()

    def bindings(self, scope: str) -> Dict[str, List[ast.AST]]:
        """name -> the values assigned to it in `scope`'s own statements
        ("" = module level); `a, b = x, y` pairs its elements."""
        if scope not in self._bindings:
            out: Dict[str, List[ast.AST]] = {}
            node = self.functions[scope] if scope else self.tree
            stmts = own_nodes(node) if scope else iter(node.body)
            for s in stmts:
                if isinstance(s, ast.Assign):
                    for t in s.targets:
                        if isinstance(t, ast.Name):
                            out.setdefault(t.id, []).append(s.value)
                        elif (isinstance(t, ast.Tuple) and isinstance(s.value, ast.Tuple)
                              and len(t.elts) == len(s.value.elts)):
                            for e, v in zip(t.elts, s.value.elts):
                                if isinstance(e, ast.Name):
                                    out.setdefault(e.id, []).append(v)
                elif isinstance(s, ast.AnnAssign) and s.value is not None and \
                        isinstance(s.target, ast.Name):
                    out.setdefault(s.target.id, []).append(s.value)
            self._bindings[scope] = out
        return self._bindings[scope]

    def scopes(self, scope: str) -> List[str]:
        """`scope` and its enclosing function scopes, innermost first, then
        module level ("")."""
        parts = scope.split(".") if scope else []
        out = []
        while parts:
            q = ".".join(parts)
            if q in self.functions:
                out.append(q)
            parts.pop()
        return out + [""]


def _factory_world(idx: ModuleIndex, qual: str) -> List[str]:
    """What calling `qual` hands back: a factory's returned def and the
    defs that ride along with it."""
    if qual not in idx.factory_returns:
        return []
    return [idx.factory_returns[qual]] + idx.nested.get(qual, [])


def denotes(indexes: Dict[str, ModuleIndex], module: str, scope: str,
            expr: ast.AST, depth: int = 0) -> Set[Target]:
    """The analyzed functions that the value of `expr`, evaluated in
    `scope` of `module`, may be."""
    idx = indexes[module]
    out: Set[Target] = set()
    if depth > 6:
        return out
    if isinstance(expr, ast.Name):
        local = idx.resolve_local(expr.id, scope)
        if local:
            return {(module, local)}
        for s in idx.scopes(scope):
            values = idx.bindings(s).get(expr.id)
            if values:
                for v in values:
                    out |= denotes(indexes, module, s, v, depth + 1)
                return out
        origin = idx.imports.get(expr.id)
        if origin:
            mod, _, f = origin.rpartition(".")
            if mod in indexes and f in indexes[mod].functions:
                out.add((mod, f))
        return out
    if isinstance(expr, ast.Call):
        for mod, q in denotes(indexes, module, scope, expr.func, depth + 1):
            out |= {(mod, r) for r in _factory_world(indexes[mod], q)}
        return out
    if isinstance(expr, ast.IfExp):
        return (denotes(indexes, module, scope, expr.body, depth + 1)
                | denotes(indexes, module, scope, expr.orelse, depth + 1))
    if isinstance(expr, ast.Attribute):
        name = dotted(expr)
        if name:
            head, _, tail = name.partition(".")
            origin = idx.imports.get(head)
            if origin and origin in indexes:                  # `import mod` form
                if tail in indexes[origin].functions:
                    return {(origin, tail)}
                return out
        for mod, q in denotes(indexes, module, scope, expr.value, depth + 1):
            parent = q.rpartition(".")[0]
            cand = f"{parent}.{expr.attr}" if parent else expr.attr
            if cand in indexes[mod].functions:
                out.add((mod, cand))
        if not out:
            out |= _methods(indexes, idx, expr.attr)
        return out
    return out


def _methods(indexes: Dict[str, ModuleIndex], idx: ModuleIndex,
             attr: str) -> Set[Target]:
    """`<Class>.<attr>` of the classes `idx` defines or imports from an
    analyzed module."""
    out: Set[Target] = set()
    for cls in idx.classes:
        if f"{cls}.{attr}" in idx.functions:
            out.add((idx.module, f"{cls}.{attr}"))
    for origin in idx.imports.values():
        mod, _, cls = origin.rpartition(".")
        if mod in indexes and cls in indexes[mod].classes and \
                f"{cls}.{attr}" in indexes[mod].functions:
            out.add((mod, f"{cls}.{attr}"))
    return out


_TERMINAL_HEADS = ("torch", "np", "numpy", "math")


def callees(indexes: Dict[str, ModuleIndex], module: str, scope: str,
            nodes) -> Set[Target]:
    """The analyzed functions that the calls among `nodes` reach: each
    call's callee (a factory's returned defs too) and every function
    passed to it as an argument. torch/numpy/math calls terminate."""
    out: Set[Target] = set()
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name and name.split(".")[0] in _TERMINAL_HEADS:
            continue
        for mod, q in denotes(indexes, module, scope, node.func):
            out.add((mod, q))
            out |= {(mod, r) for r in _factory_world(indexes[mod], q)}
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(a, ast.Name):
                out |= denotes(indexes, module, scope, a)
    return out


def reachable_functions(indexes: Dict[str, ModuleIndex],
                        roots) -> Set[Target]:
    """Transitive closure of (module, qualname) callable from `roots`."""
    seen: Set[Target] = set()
    work = list(roots)
    while work:
        module, qual = work.pop()
        if (module, qual) in seen:
            continue
        idx = indexes.get(module)
        if idx is None or qual not in idx.functions:
            continue
        seen.add((module, qual))
        work.extend(callees(indexes, module, qual, own_nodes(idx.functions[qual])))
    return seen


def _loop_vars(loop: ast.AST) -> Set[str]:
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        return set(assigned_names(loop.target))
    return set()


def _outer_loops(stmts) -> Iterator[ast.AST]:
    for s in stmts:
        if isinstance(s, Loop):
            yield s
        elif isinstance(s, FuncDef + (ast.ClassDef,)):
            continue
        else:
            for field in ("body", "orelse", "finalbody"):
                yield from _outer_loops(getattr(s, field, []) or [])
            for h in getattr(s, "handlers", []) or []:
                yield from _outer_loops(h.body)


def round_loops(index: ModuleIndex) -> List[Tuple[str, ast.AST]]:
    """(qualname, loop) of each outermost loop of a function of `index`
    whose body subscripts a value with its loop variable (or subscripts
    the loop variable itself, a row of a group table): one iteration per
    round (or step, or group) over per-round inputs."""
    out: List[Tuple[str, ast.AST]] = []
    for qual, fn in index.functions.items():
        for loop in _outer_loops(fn.body):
            lv = _loop_vars(loop)
            if lv and any(isinstance(n, ast.Subscript)
                          and any(isinstance(m, ast.Name) and m.id in lv
                                  for m in [*ast.walk(n.slice), n.value])
                          for s in loop.body for n in [s, *own_nodes(s)]):
                out.append((qual, loop))
    return out
