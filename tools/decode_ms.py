#!/usr/bin/env python3
"""Host-clock times of the port's unmeshed serving steps on one CUDA card,
for comparing two trees of the port in turns within one call.

    python3 tools/decode_ms.py [--src DIR]

Imports `repro_torch` from DIR (this checkout's src/ by default; a parent
commit unpacked with `git archive` under build/ gives its own). For
zamba2-2.7b and internvl2-2b at full width and depth (f32 weights drawn
on the card from seed 0, attn_backend "pallas"), it times greedy decode
steps (`LM.decode_step`, B 2, a 64-slot cache: 4 warm-up steps, then 24
steps, each synchronised) and, for zamba2, the B 2 x S 4096 prefill of
`launch.steps.build_prefill_step` (9 flash and 54 SSD launches: the kernel
path whose launches go through the wrappers; one warm-up, then 3), and
prints one JSON line per arch with the medians, the card's name and power
limit. Every number is the host clock around work that ends in
`torch.cuda.synchronize()`.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_ms: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import LM
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()

    def timed(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    for arch in ("zamba2-2.7b", "internvl2-2b"):
        cfg = get_config(arch)
        lm = LM(cfg, attn_backend="pallas")
        params = lm.init(seed=0, device=dev, generator_device=dev)
        cache = lm.init_cache(2, 64, dtype=torch.float32, device=dev)
        tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)
        pos = iter(range(64))
        rec = {"src": args.src, "arch": arch, "card": card}
        with torch.no_grad():
            timed(lambda: lm.decode_step(params, cache, tok, next(pos)), 4)
            steps = timed(lambda: lm.decode_step(params, cache, tok, next(pos)), 24)
            rec["decode_ms_median"] = statistics.median(steps)
            rec["decode_ms"] = [round(t, 3) for t in steps]
            if arch == "zamba2-2.7b":
                shape = ShapeConfig("p", 4096, 2, "prefill")
                step = build_prefill_step(cfg, shape, None, model=lm, dtype=torch.float32).step
                toks = torch.zeros((2, 4096), dtype=torch.int32, device=dev)
                runs = timed(lambda: step(params, {"tokens": toks}), 4)
                rec["prefill_ms_median"] = statistics.median(runs[1:])
                rec["prefill_ms"] = [round(t, 2) for t in runs]
        print(json.dumps(rec), flush=True)
        del lm, params, cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
