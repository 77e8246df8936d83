"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each kernel family keeps its source under ``<family>/csrc/*.cu`` with a
plain C interface (pointers and the CUDA stream as ``void*``, every entry
point returning ``cudaGetLastError()``); headers shared between families
live under ``common/`` and are included as ``"common/<name>.cuh"``. At
first use the source is compiled for Hopper into
``build/repro_torch/lib<name>.so`` at the root of the checkout:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -I src/repro_torch/kernels \\
         -o build/repro_torch/lib<name>.so <src>

and rebuilt whenever the source, or any ``*.cuh`` header under this
directory, is newer than the library. Nothing is built when a module is
imported, so the CPU tests import every module without nvcc. `build_all`
starts one nvcc per source at once and waits for all of them; a failed
build raises with the compiler's output.

`require`, `rows_aligned` and `raise_on` are the checks ctypes wrappers make
before and after a launch.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Mapping, Tuple

import torch

KERNELS_DIR = Path(__file__).resolve().parent
ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(KERNELS_DIR))

# loaded libraries, one per name for the life of the process (ctypes keeps
# a loaded shared object mapped until exit anyway)
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin; "
                       "the CUDA kernels are built on a machine with the CUDA "
                       "toolkit")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def is_stale(lib: Path, source: Path) -> bool:
    """True when `lib` is missing or older than `source` or any shared
    header (every ``*.cuh`` under this directory counts for every source)."""
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (source, *KERNELS_DIR.rglob("*.cuh")))
    return lib.stat().st_mtime < newest


def build_all(sources: Mapping[str, Path]) -> Dict[str, Tuple[float, str]]:
    """Compile every stale source in parallel. Returns {name: (seconds,
    compiler output)} for the sources that were built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name, source in sources.items():
        if not is_stale(library_path(name), source):
            continue
        tmp = library_path(name).with_suffix(f".so.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, tmp, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, t0) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(name))
        built[name] = (time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return built


def load(name: str, source: Path) -> ctypes.CDLL:
    """The loaded library for `source`, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all({name: source})
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def require(t: torch.Tensor, what: str, dtype: torch.dtype, device: torch.device,
            numel: int) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `numel` elements
    on `device`."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if t.numel() != numel or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous tensor of {numel} "
                         f"elements, got shape {tuple(t.shape)}")


def rows_aligned(t: torch.Tensor) -> bool:
    """True when every row of a (B, S, heads, F) tensor's last axis starts
    on a 16-byte boundary (the kernels' vector loads need it)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all((s * size) % 16 == 0 for s in t.stride()[:3])


def raise_on(err: int, kernel: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {err}")
