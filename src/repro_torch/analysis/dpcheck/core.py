"""dpcheck core: violation model, suppressions, baseline, scan runner.

The port's own copy of the reference's stdlib-only core
(``repro/analysis/dpcheck/core.py``): the same `Violation`, `FileCtx`,
suppression comments (``# dpcheck: ignore[...]`` naming the rules), baseline file and
`run`, with the port's rule set. The analyzer is a set of *file checkers*
(one FileCtx at a time) and *project checkers* (the whole file set: the
kernel layout and the cross-module host-sync reachability pass). Inline
suppression applies only when the violation's path is one of the scanned
files; a violation against an unscanned path is baseline-suppressible
only. DPC501 (buffer donation) has no counterpart: torch has no donated
buffers, and the port's drivers update their state in place.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Set

RULE_DOCS: Dict[str, str] = {
    "DPC101": "PRNG key consumed by more than one sampler",
    "DPC102": "PRNG key used by a sampler after being split",
    "DPC103": "constant PRNGKey(<literal>) in library code",
    "DPC104": "sampler key argument is an opaque expression "
              "(not a name or a split/fold_in derivation)",
    "DPC105": "PRNG key with mixed ownership: escaped to a helper and "
              "reused, or escaped twice",
    "DPC201": "host sync (.item()/.tolist()/.cpu()/.numpy()/np.asarray/"
              "float/int/bool/nonzero/boolean mask/cuda.synchronize) "
              "reachable from a round loop",
    "DPC202": "python `if` on a tensor value reachable from a round loop",
    "DPC203": "print of a tensor value reachable from a round loop",
    "DPC204": "per-iteration host sync on a tensor element in a hot loop",
    "DPC301": "noise added on a path not dominated by the clip step",
    "DPC302": "bank write not masked by the ledger grant",
    "DPC401": "kernel dir missing the kernel.py/ops.py/ref.py triple or "
              "its csrc/ sources",
    "DPC402": "kernel triple file has no public function / ref exports "
              "no *_ref plain version",
    "DPC403": "kernel dir has no kernel-vs-plain-version test "
              "(tests/test_torch_*.py)",
}


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str          # repo-relative, posix separators
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    @property
    def baseline_key(self) -> str:
        return f"{self.path}::{self.rule}::{self.message}"

    def to_json(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


_SUPPRESS_RE = re.compile(r"#\s*dpcheck:\s*ignore\[([A-Za-z0-9_, ]+)\]")


def parse_suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def module_name(rel: str) -> str:
    mod = rel[:-3] if rel.endswith(".py") else rel
    if mod.startswith("src/"):
        mod = mod[len("src/"):]
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


class FileCtx:
    """One parsed source file plus everything the rules need to know."""

    def __init__(self, path: str, root: str):
        self.path = path
        self.rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=path)
        self.module = module_name(self.rel)
        self.is_library = self.rel.startswith("src/repro_torch/")
        self.suppressions = parse_suppressions(self.lines)

    def suppressed(self, v: Violation) -> bool:
        rules = self.suppressions.get(v.line)
        return bool(rules) and (v.rule in rules or "ALL" in rules)


FileChecker = Callable[[FileCtx], List[Violation]]
ProjectChecker = Callable[[List[FileCtx], str], List[Violation]]


def _checkers():
    from repro_torch.analysis.dpcheck import (rules_dporder, rules_hostsync,
                                              rules_kernels, rules_keys)
    file_checkers: List[FileChecker] = [
        rules_keys.check_file,
        rules_dporder.check_file,
        rules_hostsync.check_file_loops,
    ]
    project_checkers: List[ProjectChecker] = [
        rules_hostsync.check_project,
        rules_kernels.check_project,
    ]
    return file_checkers, project_checkers


def collect_files(paths: Sequence[str], root: str) -> List[str]:
    out: List[str] = []
    for p in paths:
        p = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")]
            out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                       if f.endswith(".py"))
    return sorted(set(out))


def run(paths: Sequence[str], root: Optional[str] = None) -> List[Violation]:
    root = os.path.abspath(root or os.getcwd())
    ctxs: List[FileCtx] = []
    violations: List[Violation] = []
    for path in collect_files(paths, root):
        try:
            ctxs.append(FileCtx(path, root))
        except SyntaxError as e:
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            violations.append(Violation("DPC000", rel, e.lineno or 1,
                                        f"syntax error: {e.msg}"))
    file_checkers, project_checkers = _checkers()
    by_rel = {c.rel: c for c in ctxs}
    for ctx in ctxs:
        for checker in file_checkers:
            violations.extend(checker(ctx))
    for pchecker in project_checkers:
        violations.extend(pchecker(ctxs, root))
    violations = [v for v in violations
                  if not (v.path in by_rel and by_rel[v.path].suppressed(v))]
    return sorted(set(violations), key=lambda v: (v.path, v.line, v.rule))


def load_baseline(path: str) -> Set[str]:
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return set(data.get("violations", []))


def write_baseline(path: str, violations: Sequence[Violation]) -> None:
    keys = sorted({v.baseline_key for v in violations})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "violations": keys}, f, indent=2)
        f.write("\n")


def filter_new(violations: Sequence[Violation],
               baseline: Set[str]) -> List[Violation]:
    return [v for v in violations if v.baseline_key not in baseline]
