#!/usr/bin/env python3
"""Device times of the `scale_noise` kernel on one CUDA card, for
comparing two trees of the port in turns within one call.

    python3 tools/scale_noise_ms.py [--src DIR] [--readings 5]

Imports `repro_torch` from DIR (this checkout's src/ by default; a parent
commit unpacked with `git archive` under build/ gives its own). On the 12
leaves of DENSE_124M's params (random weights from seed 5, keys split from
PRNGKey(10)), it times one pass of `ops.scale_noise` over the whole
leaves (12 launches) and, where the tree's wrapper takes a block, over
every leaf's four 2 x 2 blocks (48 launches, a 1-D leaf as four ranges).
Each reading is ms a pass on CUDA events over 20 passes queued behind a
device sleep, so the host's time to issue them is hidden and the events
time the device alone. It prints one JSON line: the readings, their
medians, a SHA-256 of the whole pass's output bytes (trees that draw the
same bits print the same digest), the card's name and power limit.
"""
import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys


def queued_ms(torch, fn, iters=20, sleep_cycles=400_000_000):
    """ms per call of fn() on CUDA events, queued behind a device sleep."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def two_by_two(shape):
    """(offsets, local shape) of the four blocks of a leaf cut in two on
    its last two dims."""
    *lead, r, c = shape
    for i in (0, 1):
        for j in (0, 1):
            yield (0,) * len(lead) + (i * r // 2, j * c // 2), tuple(lead) + (r // 2, c // 2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    ap.add_argument("--readings", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scale_noise_ms: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.kernels.dp_clip_noise import ops
    from repro_torch.models import LM
    from repro_torch.tree_util import tree_flatten
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    leaves = tree_flatten(LM(DENSE_124M).init(seed=5, device=dev))[0]
    keys = random.split(random.PRNGKey(10, device=dev), len(leaves))
    cs, ns = torch.tensor([0.5], device=dev), torch.tensor(0.37, device=dev)

    def whole_pass():
        return [ops.scale_noise(x, k, cs, ns) for x, k in zip(leaves, keys)]

    passes = {"whole": whole_pass}
    if "block" in inspect.signature(ops.scale_noise).parameters:
        blocks = []
        for x, k in zip(leaves, keys):
            shape = tuple(x.shape) if x.dim() >= 2 else (4, x.numel() // 4)
            for offsets, local in two_by_two(shape):
                sl = tuple(slice(o, o + n) for o, n in zip(offsets, local))
                blocks.append((x.reshape(shape)[sl].contiguous(), k, shape, offsets))
        passes["blocks"] = lambda: [ops.scale_noise(b, k, cs, ns, (shape, off))
                                    for b, k, shape, off in blocks]
    digest = hashlib.sha256()
    for out in whole_pass():
        digest.update(out.cpu().numpy().tobytes())
    rec = {"src": args.src, "card": card, "elements": sum(x.numel() for x in leaves),
           "whole_sha256": digest.hexdigest()}
    for what, fn in passes.items():
        fn()                                    # build and warm up
        readings = [queued_ms(torch, fn) for _ in range(args.readings)]
        rec[f"{what}_ms"] = [round(t, 4) for t in readings]
        rec[f"{what}_ms_median"] = statistics.median(readings)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
