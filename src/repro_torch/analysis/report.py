"""Markdown tables of the dry-run records: the reference's
``repro/analysis/report.py``, kept as the port's own copy with the same
tables, columns and units.

    PYTHONPATH=src python -m repro_torch.analysis.report [--dir results/dryrun]

A record of ``repro_torch.launch.dryrun`` carries its cost under
"op_cost" and its trace time under "trace_s" (nothing is lowered or
compiled): the "lower s" column shows that time and "compile s" is "-".
The reference's records (under "hlo_walker", "lower_s", "compile_s") give
the reference's tables unchanged.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if b < 1024 or unit == "TiB":
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}TiB"


def load(d, include_variants: bool = False):
    recs = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if r.get("variant") and not include_variants:
            continue   # §Perf A/B runs live in their own table
        recs.append(r)
    return recs


def dryrun_table(recs, mesh):
    out = ["| arch | shape | ok | lower s | compile s | arg bytes/dev | "
           "temp bytes/dev | coll bytes/dev |",
           "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        ma = r.get("memory_analysis") or {}
        w = r.get("op_cost") or r.get("hlo_walker", {})
        out.append(
            f"| {r['arch']} | {r['shape']} | {'YES' if r['ok'] else 'NO'} "
            f"| {r.get('trace_s', r.get('lower_s', '-'))} | {r.get('compile_s', '-')} "
            f"| {fmt_bytes(ma.get('argument_size_in_bytes', 0))} "
            f"| {fmt_bytes(ma.get('temp_size_in_bytes', 0))} "
            f"| {fmt_bytes(w.get('collective_bytes_total', 0))} |")
    return "\n".join(out)


def roofline_table(recs):
    out = ["| arch | shape | compute s | memory s | collective s | dominant "
           "| model TFLOPs | HLO/model | what would move the dominant term |",
           "|---|---|---|---|---|---|---|---|---|"]
    hints = {
        ("train", "memory"): "fp32 score traffic in blockwise attention -> "
                             "bf16 operands / Pallas flash (VMEM-resident)",
        ("prefill", "memory"): "same: attention score materialization; "
                               "Pallas flash kernel",
        ("decode", "memory"): "KV-cache streaming is intrinsic; "
                              "quantized (int8) cache halves it",
        ("train", "collective"): "fewer microbatches / hoist FSDP gathers",
        ("train", "compute"): "remat policy (save dots)",
    }
    for r in recs:
        if r["mesh"] != "pod16x16" or not r.get("ok"):
            continue
        rf = r["roofline"]
        kind = ("train" if r["shape"] == "train_4k"
                else "prefill" if r["shape"] == "prefill_32k" else "decode")
        hint = hints.get((kind, rf["dominant"]), "-")
        ratio = rf["useful_flops_ratio"]
        inv = 1.0 / ratio if ratio else float("inf")
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3g} "
            f"| {rf['memory_s']:.3g} | {rf['collective_s']:.3g} "
            f"| **{rf['dominant']}** | {rf['model_flops_total']/1e12:.3g} "
            f"| {inv:.2f}x | {hint} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--section", choices=["dryrun", "roofline", "both"],
                    default="both")
    args = ap.parse_args()
    recs = load(args.dir)
    if args.section in ("dryrun", "both"):
        print("### Single-pod mesh (16 x 16 = 256 chips)\n")
        print(dryrun_table(recs, "pod16x16"))
        print("\n### Multi-pod mesh (2 x 16 x 16 = 512 chips)\n")
        print(dryrun_table(recs, "pod2x16x16"))
    if args.section in ("roofline", "both"):
        print("\n### Roofline (single-pod, per step)\n")
        print(roofline_table(recs))


if __name__ == "__main__":
    main()
