"""Run one cell of the benchmark of `repro_torch` once, on one machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, their configurations, traffic
mixes and metrics are named in BENCHMARK.json (see bench/harness/spec.py).
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each compared number beside its limit; the same numbers
end standard error. Without a CUDA device (or with fewer than the cell
asks for), or if JAX or the JAX package was loaded by the time the window
closed, it prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (`repro`; `repro_torch` is another name)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def setup_environment() -> None:
    """Caches at fixed paths inside the checkout: the kernels' builds and
    Python's bytecode of the program and its libraries (an environment that
    forbids writing it beside the sources would have every run compile
    torch again); no library loads JAX; one host thread for CPU ops (the
    run is one process driving the card, and idle OpenMP workers only take
    cores from it); the checkout and its src/ importable."""
    cache = ROOT / "build" / "bench-cache"
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_environment()
    import torch

    from bench.harness import cell as cell_mod
    from bench.harness import spec

    c = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"{args.workload} needs {c.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = cell_mod.run(c, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}; the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    lines = out.pop("_lines")
    print(json.dumps(out), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
