"""Recompute the cost and roofline of every dry-run record from its SAVED
trace (nothing is traced again). The counterpart of
``repro/analysis/reanalyze.py``.

    PYTHONPATH=src python -m repro_torch.analysis.reanalyze [--dir results/dryrun]

Used when the cost model (``op_cost.cost_of``) or the roofline changes: the
dry-run saves results/dryrun/trace/<tag>.trace.json.zst; this rewrites
every record's op_cost and roofline sections in place.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.analysis.op_cost import cost_of, load_trace
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch.dryrun import record_roofline


def reanalyze_one(json_path: str) -> bool:
    with open(json_path) as f:
        rec = json.load(f)
    if not rec.get("ok"):
        return False
    tag = os.path.basename(json_path)[:-len(".json")]
    trace_path = os.path.join(os.path.dirname(json_path), "trace", tag + ".trace.json.zst")
    if not os.path.exists(trace_path):
        return False
    walked = cost_of(load_trace(trace_path)["events"])
    rec["op_cost"] = walked
    cfg = get_config(rec["arch"])
    if rec.get("reduced"):
        cfg = cfg.reduced()
    rec["roofline"] = record_roofline(cfg, INPUT_SHAPES[rec["shape"]], walked, rec["chips"])
    with open(json_path, "w") as f:
        json.dump(rec, f, indent=1)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    args = ap.parse_args(argv)
    n = 0
    for p in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        if reanalyze_one(p):
            n += 1
            print("reanalyzed", os.path.basename(p))
    print(f"{n} records updated")


if __name__ == "__main__":
    main()
