"""The traced set: the program's own spans (`repro_torch.telemetry`) laid
over a device trace, for the per-layer metrics `host_syncs`,
`model_host_ms`, `privatizer_host_ms`, `model_device_ms` and
`privatizer_device_ms`.

    t = traced(ctx)        # a Traced, or None off the card or without telemetry
    t.model_device_s, t.privatizer_device_s, t.model_host_s, ...

With `--trace 1` the first of those readers runs the set, once per run,
and keeps it on the run's `Context`; it prints its lines (the per-span
table, the idle gaps by span, the clock check and the tracing overhead)
on standard error. The set runs after the run's own window, profiled
dispatches and check, so every other metric reads what it read before: a
fresh session and state of the cell from the run's `--seed`, the checked
dispatch's shape run once untraced (which warms the shapes, as set-up
does), then `profiled_dispatches` dispatches under `telemetry.recording()`
and the profiler with `trace.profile`'s device-only settings, the whole
set closed by one synchronize. A checkout whose program has no
`repro_torch.telemetry` (an earlier commit's) gives None and runs nothing.

A device op is put down to the span that was open when its launch call
ran: the CUDA runtime event with the op's correlation id (the earliest
such event; lazy loading shares the id), and the innermost span covering
that event's start, all on `time.time_ns()`'s clock, which the
profiler's events share. An idle gap between device ops of at least
`trace.GAP_S` is put down to the innermost span covering its midpoint, or
to OUTSIDE. A span's layer is the prefix of its name: `model.*` is the
model, `engine.*` and `privatizer.*` the engine and privatizer. The
clock check reads the share of device time whose launch lies inside a
`session.run_rounds` span (below 99% the clocks or the spans are off),
and counts the device ops that start before their own launch call, with
the most by which one does (the lead): the profiler puts the device's
timestamps on the host's clock only to within an offset, which read 0 to
22.6 ms on an H100. A launch is put down to its span on the host's clock
alone; an idle gap is taken on the device's clock moved later by the
lead, the least shift under which no op starts before its launch call."""
from __future__ import annotations

import argparse
import collections
import gc
import importlib.util
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench.harness import data, program, trace
from bench.reference import model as RM

ROOT_SPAN = "session.run_rounds"
OUTSIDE = "outside run_rounds"
CHUNK = 4096                      # device ops per block of the span lookup


@dataclass
class SpanRow:
    """One span name's totals over the traced set."""
    count: int = 0
    host_s: float = 0.0           # summed durations
    self_s: float = 0.0           # less what child spans cover
    device_s: float = 0.0         # device ops launched with this the innermost span
    idle_s: float = 0.0           # idle gaps whose midpoint this is the innermost span of
    syncs: int = 0


@dataclass
class Traced:
    rounds: int
    dispatches: int
    wall_s: float = 0.0           # host clock over the traced set, to its synchronize
    model_host_s: float = 0.0
    privatizer_host_s: float = 0.0
    model_device_s: float = 0.0
    privatizer_device_s: float = 0.0
    device_s: float = 0.0         # every device op's time
    busy_s: float = 0.0           # their union
    in_run_rounds_s: float = 0.0  # device time launched inside session.run_rounds
    unmatched: int = 0            # device ops with no launch call in the trace
    before_launch: int = 0        # device ops that start before their launch call
    lead_s: float = 0.0           # by at most this much (the device clock's offset)
    syncs: int = 0                # host syncs counted inside session.run_rounds
    syncs_outside: int = 0
    by_span: Dict[str, SpanRow] = field(default_factory=dict)


def layer(name: str) -> Optional[str]:
    """"model", "privatizer" (engine and privatizer) or None, by the span's name."""
    head = name.split(".", 1)[0]
    if head == "model":
        return "model"
    if head in ("engine", "privatizer"):
        return "privatizer"
    return None


def innermost(starts: np.ndarray, ends: np.ndarray, t: np.ndarray) -> np.ndarray:
    """For each time of `t`, the index of the innermost span covering it, -1
    for none. Spans of one thread nest, and are listed in the order they
    opened, so the innermost cover is the one opened last."""
    out = np.full(t.shape, -1, np.int64)
    if not starts.size:
        return out
    for a in range(0, t.size, CHUNK):
        tt = t[a:a + CHUNK, None]
        cover = (starts[None, :] <= tt) & (tt <= ends[None, :])
        last = starts.size - 1 - np.argmax(cover[:, ::-1], axis=1)
        out[a:a + CHUNK] = np.where(cover.any(axis=1), last, -1)
    return out


def reduce(spans: Sequence, ops: Sequence[Tuple[str, int, int, int]],
           launches: Sequence[Tuple[str, int, int, int]], rounds: int, dispatches: int,
           wall_s: float = 0.0, outside_syncs: int = 0) -> Traced:
    """The traced set's numbers from its spans (telemetry.Span: name,
    start_ns, end_ns, parent, syncs), its device ops and the runtime calls
    (each (name, start_ns, end_ns, correlation id))."""
    out = Traced(rounds, dispatches, wall_s=wall_s, syncs_outside=outside_syncs)
    n = len(spans)
    starts = np.array([s.start_ns for s in spans], np.int64)
    ends = np.array([s.end_ns for s in spans], np.int64)
    names = [s.name for s in spans]
    root = list(range(n))
    for i, s in enumerate(spans):
        if s.parent >= 0:
            root[i] = root[s.parent]
    child_s = np.zeros(n)
    for s in spans:
        if s.parent >= 0:
            child_s[s.parent] += (s.end_ns - s.start_ns) * 1e-9
    rows = collections.defaultdict(SpanRow)
    for i, s in enumerate(spans):
        r = rows[s.name]
        dur = (s.end_ns - s.start_ns) * 1e-9
        r.count += 1
        r.host_s += dur
        r.self_s += dur - child_s[i]
        r.syncs += s.syncs
        lay = layer(s.name)
        if lay == "model":
            out.model_host_s += dur
        elif lay == "privatizer":
            out.privatizer_host_s += dur - child_s[i]
        if names[root[i]] == ROOT_SPAN:
            out.syncs += s.syncs
        else:
            out.syncs_outside += s.syncs

    launch_at: Dict[int, int] = {}
    for _, start, _, corr in launches:
        if corr and (corr not in launch_at or start < launch_at[corr]):
            launch_at[corr] = start
    if ops:
        o_start = np.array([o[1] for o in ops], np.int64)
        o_end = np.array([o[2] for o in ops], np.int64)
        dur = (o_end - o_start) * 1e-9
        at = np.array([launch_at.get(o[3], -1) for o in ops], np.int64)
        matched = at >= 0
        out.unmatched = int(np.sum(~matched))
        early = matched & (o_start < at)
        out.before_launch = int(np.sum(early))
        lead = int(np.max(at[early] - o_start[early], initial=0))
        out.lead_s = lead * 1e-9
        who = np.where(matched, innermost(starts, ends, at), -1)
        out.device_s = float(dur.sum())
        for i in np.nonzero(who >= 0)[0]:
            j = who[i]
            rows[names[j]].device_s += dur[i]
            lay = layer(names[j])
            if lay == "model":
                out.model_device_s += dur[i]
            elif lay == "privatizer":
                out.privatizer_device_s += dur[i]
            if names[root[j]] == ROOT_SPAN:
                out.in_run_rounds_s += dur[i]
        # the device's clock moved by the least shift under which no op starts
        # before its launch call, so that a gap's midpoint meets the host's spans
        ms, me = trace._union((o_start + lead).astype(np.float64),
                              (o_end + lead).astype(np.float64))
        out.busy_s = float(np.sum(me - ms)) * 1e-9
        gs, ge = me[:-1], ms[1:]
        long = (ge - gs) * 1e-9 >= trace.GAP_S
        mids = (0.5 * (gs[long] + ge[long])).astype(np.int64)
        for m, g in zip(innermost(starts, ends, mids), (ge[long] - gs[long]) * 1e-9):
            rows[names[m] if m >= 0 else OUTSIDE].idle_s += float(g)
    out.by_span = dict(rows)
    return out


def lines(t: Traced, untraced_wall_s: Optional[float], untraced_rounds: int) -> List[str]:
    """The traced set's lines for standard error."""
    ms = 1e3 / max(t.rounds, 1)
    out = [f"spans: {t.dispatches} traced dispatches, {t.rounds} rounds, "
           f"{t.wall_s:.6f} s of wall ({t.wall_s * ms:.6f} ms a round)"]
    if untraced_wall_s and untraced_rounds:
        per = 1e3 * untraced_wall_s / untraced_rounds
        out.append(f"spans: tracing overhead: {t.wall_s * ms:.6f} ms a round traced against "
                   f"{per:.6f} untraced ({100.0 * (t.wall_s * ms / per - 1.0):+.3f}%)")
    share = 100.0 * t.in_run_rounds_s / t.device_s if t.device_s else 0.0
    out.append(f"spans: clock check: {share:.4f}% of device time launched inside "
               f"{ROOT_SPAN}; {t.unmatched} device ops without a launch call, "
               f"{t.before_launch} starting before their launch call, by at most "
               f"{t.lead_s * 1e6:.3f} us")
    if t.busy_s:
        cover = 100.0 * (t.model_device_s + t.privatizer_device_s) / t.busy_s
        out.append(f"spans: model {t.model_device_s * ms:.6f} + engine and privatizer "
                   f"{t.privatizer_device_s * ms:.6f} device ms a round = {cover:.4f}% of "
                   f"busy {t.busy_s * ms:.6f}")
    out.append(f"spans: host syncs {t.syncs} inside {ROOT_SPAN}, {t.syncs_outside} outside")
    out.append("spans: span | count | host ms/round | self ms/round | device ms/round | "
               "idle s | syncs")
    for name, r in sorted(t.by_span.items(), key=lambda kv: -kv[1].host_s):
        out.append(f"spans: {name} | {r.count} | {r.host_s * ms:.6f} | {r.self_s * ms:.6f} | "
                   f"{r.device_s * ms:.6f} | {r.idle_s:.6f} | {r.syncs}")
    return out


def _run_seed() -> int:
    """The run's --seed (bench/run.py's argument), 0 where there is none."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args()[0].seed


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def record(cell, seed: int, device: torch.device):
    """Run the traced set of `cell`: (recording, device ops, runtime calls,
    wall seconds, dispatches, rounds). Needs `repro_torch.telemetry`."""
    from repro_torch import telemetry
    t = cell.traffic
    mspec = RM.ModelSpec.from_config(cell.config)
    _free(device)
    fed, state = program.build(cell.config, t, RM.make_params(mspec, seed, device), device)
    inputs = data.make(t, mspec.vocab, seed, device, program.schedule_draw(fed))
    state, _ = program.dispatch(fed, state, inputs.check_batch, inputs.check_seq,
                                data.as_key(inputs.check_key), t)
    n = t["profiled_dispatches"]
    keys = [data.as_key(inputs.dispatch_keys[j]) for j in range(n)]   # launched before the set
    cuda = device.type == "cuda"
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA] if cuda else [act.CPU]) as prof:
        t0 = time.perf_counter()
        with telemetry.recording() as rec:
            for j in range(n):
                state, _ = program.dispatch(fed, state, *inputs.dispatch(j), keys[j], t)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del state, fed, inputs
    _free(device)
    ops, launches = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        row = (e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
        (ops if e.device_type() == torch.autograd.DeviceType.CUDA else launches).append(row)
    return rec, ops, launches, wall, n, n * t["rounds_per_dispatch"]


def traced(ctx) -> Optional[Traced]:
    """The run's traced set, run at the first call on the card and kept on
    `ctx`; None off the card, without a profile, or where the program has
    no telemetry."""
    if hasattr(ctx, "traced_set"):
        return ctx.traced_set
    out = None
    if (ctx.device.type == "cuda" and ctx.profile is not None
            and importlib.util.find_spec("repro_torch.telemetry") is not None):
        rec, ops, launches, wall, n, rounds = record(ctx.cell, _run_seed(), ctx.device)
        out = reduce(rec.spans, ops, launches, rounds, n, wall_s=wall,
                     outside_syncs=rec.host_syncs - sum(s.syncs for s in rec.spans))
        for line in lines(out, ctx.profile.span_s, ctx.profile_rounds):
            print(line, file=sys.stderr)
    ctx.traced_set = out
    return out
