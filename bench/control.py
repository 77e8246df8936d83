"""The control of the benchmark's check, and its planted faults, at a cell's
own size: the plain reference put in the program's place, computed in the
next precision below the configuration's (TF32 products for f32 with TF32
off), or with a fault planted in it, compared with the reference as a run
compares the program. Each seed prints one JSON line of the compared
numbers and whether any is over its limit.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --mode tf32
    python3 bench/control.py --workload <cell> --seeds 11,12,13 --mode half_batch

(`stale_carry`, each group reading the state of one group earlier, is
held by the CPU tests alone: it keeps two states' rows on the device.)

The benchmark's own runs never run this; it gives the upper readings the
limits in bench/limits/ are set below (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

MODES = ("tf32", "half_batch", "stale_carry")


def readings(cell, seed: int, mode: str, device) -> dict:
    """The compared numbers of the control (mode "tf32") or of the planted
    fault `mode` against the reference, for `seed` at the cell's size."""
    import torch

    from bench.harness import cell as run_cell
    from bench.harness import check, data
    from bench.reference import federation as RF
    from bench.reference import model as RM
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    device = torch.device(device)
    fspec = RF.FedSpec.from_traffic(cell.traffic)
    vocab = RM.ModelSpec.from_config(cell.config).vocab
    inputs = data.make(cell.traffic, vocab, seed, device,
                       lambda key, n: RF.owner_sequence(key.to(torch.int64), fspec, n))
    keep = run_cell.watched(inputs.check_seq, seed)
    ctl = run_cell.reference(cell, seed, inputs, 0, device, keep=keep, tf32=mode == "tf32",
                             fault=None if mode == "tf32" else mode)
    ref = run_cell.reference(cell, seed, inputs, 0, device, watch=ctl.pop("rows"))
    ctl["leaf_grads"] = ref.pop("judged")
    nums = check.numbers(ctl, ref, cell.update_tolerance)
    return {"seed": seed, "mode": mode, "numbers": nums,
            "fails": not check.verdict(nums, cell.limits)[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--mode", choices=MODES, default="tf32")
    args = ap.parse_args(argv)
    import torch

    from bench.harness import spec
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(readings(cell, int(s), args.mode, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
