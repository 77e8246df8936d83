"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each kernel family keeps its source under ``<family>/csrc/*.cu`` with a
plain C interface (pointers and the CUDA stream as ``void*``, every entry
point returning ``cudaGetLastError()``). At first use the source is compiled
for Hopper into ``build/repro_torch/lib<name>.so`` at the root of the
checkout:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/lib<name>.so <src>

and rebuilt whenever the source is newer than the library. Nothing is
built when a module is imported, so the CPU tests import every module
without nvcc. `build_all` starts one nvcc per source at once and waits for
all of them; a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Mapping, Tuple

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _stale(name: str, source: Path) -> bool:
    lib = library_path(name)
    return not lib.exists() or lib.stat().st_mtime < source.stat().st_mtime


def build_all(sources: Mapping[str, Path]) -> Dict[str, Tuple[float, str]]:
    """Compile every stale source in parallel. Returns {name: (seconds,
    compiler output)} for the sources that were built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name, source in sources.items():
        if not _stale(name, source):
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
