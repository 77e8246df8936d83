"""The device trace of a few dispatches: torch.profiler around them, reduced
to what the per-layer metrics read.

    out, prof = profile(run, device)   # run() once under the profiler
    prof.kernels                       # {device op name: (seconds, launches)}
    prof.busy_s, prof.span_s           # union of device-op time, the traced window
    prof.gaps                          # {what the host was doing: idle seconds}

On the card the profiler records the device alone (CUDA activity: kernels,
copies, and the CUDA runtime calls that launched them), not the host's
torch ops: recording every op of a round slows the host by a quarter and
more, which the idle share would then read. The window is the host clock
from the call to the end of the synchronize that closes it. An idle gap is
an interval between device ops; gaps of at least GAP_S are named by the
innermost CUDA runtime call that covers their midpoint ("host between CUDA
calls" where none does), the MAX_NAMED longest one by one and the rest
together, shorter ones together as launch gaps. On the CPU the profiler
records host ops only and every device number stays empty or zero."""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import numpy as np
import torch

GAP_S = 50e-6
SHORT = f"launch gaps under {int(GAP_S * 1e6)} us"
MAX_NAMED = 2000
UNNAMED = "shorter gaps not named"
HOST = "host between CUDA calls"


@dataclass
class Profile:
    kernels: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    busy_s: float = 0.0
    span_s: float = 0.0
    gaps: Dict[str, float] = field(default_factory=dict)


def kernel_group(name: str) -> str:
    """The group of a device op, by its name (as PERF.md's profiles group
    them)."""
    low = name.lower()
    if "dp_round" in low:
        return "dp_round"
    if "sqnorm" in low:
        return "sqnorm"
    if "scale_noise" in low:
        return "scale_noise"
    if "ssd_chunk" in low:
        return "ssd_bwd" if "bwd" in low else "ssd"
    if "flash_attention" in low:
        return "flash"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    return "other"


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged [start, end) intervals, in order."""
    order = np.argsort(starts)
    out_s, out_e = [], []
    for s, e in zip(starts[order], ends[order]):
        if out_e and s <= out_e[-1]:
            out_e[-1] = max(out_e[-1], e)
        else:
            out_s.append(s)
            out_e.append(e)
    return np.asarray(out_s), np.asarray(out_e)


def profile(run: Callable[[], object], device: torch.device) -> Tuple[object, Profile]:
    """run() once under torch.profiler, then synchronize; (its result, the
    reduced trace)."""
    cuda = device.type == "cuda"
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA] if cuda else [act.CPU]) as prof:
        t0 = time.perf_counter()
        out = run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    p = Profile(span_s=wall)
    kern_s, kern_n = collections.Counter(), collections.Counter()
    ks, ke, cs, ce, names = [], [], [], [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kern_s[e.name()] += e.duration_ns() * 1e-9
            kern_n[e.name()] += 1
            ks.append(e.start_ns())
            ke.append(e.end_ns())
        else:
            cs.append(e.start_ns())
            ce.append(e.end_ns())
            names.append(e.name())
    p.kernels = {n: (kern_s[n], kern_n[n]) for n in kern_s}
    if not ks:
        return out, p
    ms, me = _union(np.asarray(ks, np.float64), np.asarray(ke, np.float64))
    p.busy_s = float(np.sum(me - ms)) * 1e-9
    gs, ge = me[:-1], ms[1:]
    gaps = collections.Counter()
    short = (ge - gs) * 1e-9 < GAP_S
    gaps[SHORT] += float(np.sum(ge[short] - gs[short])) * 1e-9
    gs, ge = gs[~short], ge[~short]
    order = np.argsort(gs - ge)[:MAX_NAMED]
    rest = np.ones(gs.size, bool)
    rest[order] = False
    if rest.any():
        gaps[UNNAMED] += float(np.sum(ge[rest] - gs[rest])) * 1e-9
    cs, ce = np.asarray(cs, np.float64), np.asarray(ce, np.float64)
    for a, b in zip(gs[order], ge[order]):
        mid = 0.5 * (a + b)
        cover = np.nonzero((cs <= mid) & (ce >= mid))[0]
        name = names[cover[np.argmin(ce[cover] - cs[cover])]] if cover.size else HOST
        gaps[name] += (b - a) * 1e-9
    gaps["before the first and after the last device op"] = max(
        0.0, wall - float(me[-1] - ms[0]) * 1e-9)
    p.gaps = dict(gaps)
    return out, p
