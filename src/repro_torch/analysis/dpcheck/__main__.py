"""CLI: ``python -m repro_torch.analysis.dpcheck [paths...]``.

Exit status is 0 when no NEW violations remain (after per-line
suppressions and the baseline file), 1 otherwise. ``--write-baseline``
snapshots the current findings so CI fails only on regressions. The
default paths are the port (``src/repro_torch``), ``chip_smoke.py`` and
the port's examples (``examples/*_torch.py``), relative to ``--root``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.analysis.dpcheck.core import (RULE_DOCS, filter_new, load_baseline, run,
                                               write_baseline)


def default_paths(root: str):
    """The port's own files under `root`: its package, chip_smoke.py and
    examples/*_torch.py (those that exist)."""
    paths = [p for p in ("src/repro_torch", "chip_smoke.py")
             if os.path.exists(os.path.join(root, p))]
    return paths + sorted(os.path.relpath(p, root) for p in
                          glob.glob(os.path.join(root, "examples", "*_torch.py")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.dpcheck",
        description="DP-invariant static analyzer for the port (rules "
                    "DPC1xx-DPC4xx).")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to scan (default: src/repro_torch, "
                         "chip_smoke.py, examples/*_torch.py)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON; known violations do not fail")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to --baseline and exit 0")
    ap.add_argument("--root", default=None,
                    help="repo root for relative paths (default: cwd)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, doc in sorted(RULE_DOCS.items()):
            print(f"{rule}  {doc}")
        return 0

    root = os.path.abspath(args.root or os.getcwd())
    violations = run(args.paths or default_paths(root), root=root)
    if args.write_baseline:
        if not args.baseline:
            ap.error("--write-baseline requires --baseline")
        write_baseline(args.baseline, violations)
        print(f"wrote {len(violations)} entries to {args.baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else set()
    new = filter_new(violations, baseline)

    if args.format == "json":
        print(json.dumps({
            "violations": [v.to_json() for v in violations],
            "new": [v.to_json() for v in new],
            "baseline_entries": len(baseline),
            "count": len(violations),
            "new_count": len(new),
        }, indent=2))
    else:
        for v in new:
            print(v.format())
        known = len(violations) - len(new)
        tail = f" ({known} known in baseline)" if known else ""
        print(f"dpcheck: {len(new)} new violation(s)"
              f", {len(violations)} total{tail}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
