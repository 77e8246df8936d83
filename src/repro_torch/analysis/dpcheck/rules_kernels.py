"""DPC4xx — kernel layout conformance.

Every directory under src/repro_torch/kernels/ that holds Python modules
must ship the port's kernel.py / ops.py / ref.py triple and its CUDA
sources under csrc/ (DPC401), each module exporting at least one public
function and ref.py at least one ``*_ref`` plain version whose stem
matches a kernel/ops public name (DPC402), and at least one
``tests/test_torch_*.py`` must reference ``kernels.<name>`` so the kernel
is held against its plain version (DPC403).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List

from repro_torch.analysis.dpcheck.core import FileCtx, Violation

TRIPLE = ("kernel.py", "ops.py", "ref.py")
SOURCES = (".cu", ".cuh", ".cpp")


def _public_functions(ctx: FileCtx) -> List[str]:
    return [n.name for n in ctx.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and not n.name.startswith("_")]


def _has_sources(path: str) -> bool:
    return os.path.isdir(path) and any(f.endswith(SOURCES) for f in os.listdir(path))


def check_project(ctxs: List[FileCtx], root: str) -> List[Violation]:
    out: List[Violation] = []
    by_rel = {c.rel: c for c in ctxs}
    kernel_dirs: Dict[str, List[str]] = {}
    for c in ctxs:
        parts = c.rel.split("/")
        if ("kernels" in parts
                and parts.index("kernels") + 3 == len(parts)
                and parts[-1] != "__init__.py"):
            kdir = "/".join(parts[:-1])
            kernel_dirs.setdefault(kdir, []).append(parts[-1])

    tests_dir = os.path.join(root, "tests")
    test_sources = ""
    if os.path.isdir(tests_dir):
        for f in sorted(os.listdir(tests_dir)):
            if f.startswith("test_torch_") and f.endswith(".py"):
                with open(os.path.join(tests_dir, f), encoding="utf-8") as fh:
                    test_sources += fh.read()

    for kdir, files in sorted(kernel_dirs.items()):
        kname = kdir.split("/")[-1]
        missing = [f for f in TRIPLE if f not in files]
        if not _has_sources(os.path.join(root, kdir, "csrc")):
            missing.append("csrc/")
        if missing:
            # anchor to a scanned file in the dir so inline suppression
            # (core.run only consults files it parsed) can silence it
            out.append(Violation(
                "DPC401", f"{kdir}/{sorted(files)[0]}", 1,
                f"kernel `{kname}` is missing {', '.join(missing)} — the "
                "kernel/ops/ref triple and its CUDA sources are mandatory"))
            continue
        pub: Dict[str, List[str]] = {}
        for f in TRIPLE:
            ctx = by_rel.get(f"{kdir}/{f}")
            pub[f] = _public_functions(ctx) if ctx else []
            if ctx and not pub[f]:
                out.append(Violation(
                    "DPC402", ctx.rel, 1,
                    f"kernel `{kname}`: {f} exports no public function"))
        refs = [n for n in pub["ref.py"] if n.endswith("_ref")]
        impl_tokens = {t for n in pub["kernel.py"] + pub["ops.py"]
                       for t in n.split("_")}
        if pub["ref.py"] and not any(
                set(r[: -len("_ref")].split("_")) & impl_tokens
                for r in refs):
            out.append(Violation(
                "DPC402", f"{kdir}/ref.py", 1,
                f"kernel `{kname}`: no *_ref plain version matching a public "
                "kernel/ops function"))
        if test_sources and f"kernels.{kname}" not in test_sources:
            out.append(Violation(
                "DPC403", f"{kdir}/kernel.py", 1,
                f"kernel `{kname}` has no kernel-vs-plain-version test in "
                f"tests/test_torch_*.py (none imports kernels.{kname})"))
    return out
