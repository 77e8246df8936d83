"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up (counted in `setup_s`, from the process's start): the weights from
the seed on the device, the session and its state, the inputs
(`harness.data`) and the checked dispatch: the training's first K rounds,
through the window's own call and feed, which also warms the shapes the
window runs (its K, batch and sequence; a grouped traffic file's schedule
key gives a checked dispatch with groups of every size up to the cap).
The check's copy to the host of the rows whose gradient it
reads (LEAF_ROWS owners of the checked dispatch, drawn from the seed) is
check work and left out of `setup_s`. The window then runs whole dispatches
back to back, with no synchronize of its own, and closes at the first
dispatch boundary after `seconds` with one `torch.cuda.synchronize()`.
`tokens_per_s` is the tokens of the window's answered rounds over the
window. With `trace`, the same window is followed by `profiled_dispatches`
dispatches under the profiler, and the per-layer metrics are read.

After the window the program's state is read (ledger, peak memory) and
freed, and the reference recomputes the checked dispatch from the same
weights, batches and keys (`harness.check`). Every metric, end-to-end or
per-layer, is read from the run's `Context` by its reader
(`spec.reader`)."""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bench.harness import check, data, program, spec, trace
from bench.reference import federation as RF
from bench.reference import model as RM
from bench.reference import threefry as T

# owners whose rows grad_leaf_gap reads: each row costs a copy of P floats
# to pinned host memory after the checked dispatch
LEAF_ROWS = 3


@dataclass
class Context:
    """What a per-layer metric's reader may read (bench/metrics/*.py)."""
    cell: spec.Cell
    model: RM.ModelSpec
    device: torch.device
    setup_s: float = 0.0
    peak_bytes: int = 0
    window_s: float = 0.0
    window_rounds: int = 0            # answered rounds in the window
    window_dispatches: int = 0
    window_host_in_call_s: float = 0.0
    window_launches: Dict[str, int] = field(default_factory=dict)
    profile: Optional[trace.Profile] = None
    profile_rounds: int = 0
    profile_launches: Dict[str, int] = field(default_factory=dict)
    state_bytes: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


def _changes(theta: torch.Tensor, rows: Dict[int, torch.Tensor], base: torch.Tensor,
             sizes: List[int]) -> Dict[object, List[float]]:
    out = {"theta_L": RF.leaf_change_norms(theta, base, sizes)}
    for o, row in rows.items():
        out[o] = RF.leaf_change_norms(row, base, sizes)
    return out


def watched(check_seq, seed: int, n: int = LEAF_ROWS) -> List[int]:
    """The `n` owners of the checked dispatch whose rows grad_leaf_gap
    reads: drawn from the seed among its distinct owners."""
    owners = sorted({int(o) for o in check_seq})
    pick = np.random.default_rng(int(seed)).choice(len(owners), min(n, len(owners)),
                                                   replace=False)
    return sorted(owners[i] for i in pick)


def reference(cell: spec.Cell, seed: int, inputs: data.Inputs, n_dispatches: int, device,
              watch: Optional[Dict[int, torch.Tensor]] = None, keep: Sequence[int] = (),
              tf32: bool = False, fault: Optional[str] = None) -> dict:
    """What the reference computes for a run that made the checked
    dispatch and `n_dispatches` window-shaped ones: every drawn owner, the
    ledger, and the checked dispatch's owners, gradient norms, changes and
    the watched owners' per-leaf gradients (check.numbers' keys); under
    "judged", the per-leaf gradients that the judged rows `watch` imply,
    and under "rows" the reference's own rows of the owners `keep`.
    `tf32` computes its products in TF32 and `fault` plants the fault of
    that name ("half_batch", "stale_carry"; `reference.federation`): the
    control and a fault put in the program's place."""
    t = cell.traffic
    watch = watch or {}
    mspec, fspec = RM.ModelSpec.from_config(cell.config), RF.FedSpec.from_traffic(t)
    K, pool = t["rounds_per_dispatch"], inputs.pool_seqs.shape[0]
    seqs = inputs.relabel[RF.owner_sequence(inputs.sched_key, fspec,
                                            (1 + pool) * K).cpu().numpy()].tolist()
    dispatched = [seqs[:K]] + [seqs[(1 + j % pool) * K:][:K] for j in range(n_dispatches)]
    spent, refused = RF.granted(dispatched, fspec)
    theta0 = RM.flat(RM.make_params(mspec, seed, device))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        traj = RF.run_dispatch(theta0, seqs[:K], T.split(inputs.check_key, K),
                               inputs.check_batch["tokens"], inputs.check_batch["labels"],
                               mspec, fspec, half_batch=fault == "half_batch",
                               stale_carry=fault == "stale_carry", watch=watch)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    sizes = [math.prod(shape) for _, shape, _ in RM.layout(mspec)]
    return {"seqs": seqs, "check_owners": traj.owners, "max_grad_norms": traj.max_grad_norms,
            "spent": spent, "refused": refused, "leaf_grads": traj.leaf_grads,
            "judged": traj.leaf_grads_judged,
            "rows": {o: traj.rows[o] for o in keep},
            "changes": _changes(traj.theta_L, traj.rows, theta0, sizes)}


def run(cell: spec.Cell, seed: int, seconds: float, trace_on: bool, device,
        t_process: float) -> dict:
    """The run's result line (a dict), its checks' lines under "_lines"."""
    device = torch.device(device)
    t = cell.traffic
    mspec = RM.ModelSpec.from_config(cell.config)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # ------------------------------ set-up ---------------------------------
    def phase(what):
        _sync(device)
        print(f"set-up: {what} done at {time.time() - t_process:.3f} s", file=sys.stderr)

    phase("imports")
    params = RM.make_params(mspec, seed, device)
    phase("weights")
    fed, state = program.build(cell.config, t, params, device)
    del params
    phase("session and state")
    inputs = data.make(t, mspec.vocab, seed, device, program.schedule_draw(fed))
    phase("inputs")
    sizes = [math.prod(shape) for _, shape, _ in RM.layout(mspec)]

    state, m = program.dispatch(fed, state, inputs.check_batch, inputs.check_seq,
                                data.as_key(inputs.check_key), t)
    theta, bank = program.flat(state)
    check_owners = [int(o) for o in m["owner"].tolist()]
    theta0 = RM.flat(RM.make_params(mspec, seed, device))
    prog = {"check_owners": check_owners,
            "max_grad_norms": [float(v) for v in m["max_grad_norm"].tolist()],
            "changes": _changes(theta, {o: bank[o] for o in set(check_owners)}, theta0, sizes)}
    del theta0
    phase("checked dispatch")
    c0 = time.time()
    rows = {o: torch.empty(bank.shape[1], dtype=bank.dtype, pin_memory=device.type == "cuda")
            .copy_(bank[o]) for o in watched(inputs.check_seq, seed)}
    check_copy_s = time.time() - c0
    del theta, bank, m
    phase(f"the check's copy of {len(rows)} rows ({check_copy_s:.3f} s, not set-up)")

    d = 0
    ctx = Context(cell, mspec, device, setup_s=time.time() - t_process - check_copy_s)

    # ------------------------------ window ---------------------------------
    refused, in_call = [], 0.0
    before = program.launch_counters()
    t0 = time.perf_counter()
    while True:
        batch, seq = inputs.dispatch(d)
        c0 = time.perf_counter()
        state, m = program.dispatch(fed, state, batch, seq,
                                    data.as_key(inputs.dispatch_keys[d]), t)
        in_call += time.perf_counter() - c0
        refused.append(m["refused"])
        d += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    ctx.window_s = window_s
    ctx.window_dispatches = len(refused)
    ctx.window_rounds = int(sum(int((~r).sum()) for r in refused))
    ctx.window_host_in_call_s = in_call
    ctx.window_launches = _diff(program.launch_counters(), before)

    if trace_on:
        n_prof = t["profiled_dispatches"]
        first = d

        def profiled():
            nonlocal state
            for j in range(first, first + n_prof):
                state, _ = program.dispatch(fed, state, *inputs.dispatch(j),
                                            data.as_key(inputs.dispatch_keys[j]), t)
        before = program.launch_counters()
        _, ctx.profile = trace.profile(profiled, device)
        ctx.profile_launches = _diff(program.launch_counters(), before)
        ctx.profile_rounds = n_prof * t["rounds_per_dispatch"]
        d += n_prof

    ctx.peak_bytes = peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    prog["spent"], prog["refused"] = program.ledger(state)
    ctx.state_bytes = program.state_bytes(state)
    del state, fed, refused, m
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------ the check ------------------------------
    prog["seqs"] = [int(o) for o in inputs.check_seq] + [int(o) for o in
                                                        inputs.pool_seqs.reshape(-1)]
    r0 = time.time()
    ref = reference(cell, seed, inputs, d, device, watch=rows)
    del rows
    print(f"check: the reference took {time.time() - r0:.3f} s", file=sys.stderr)
    prog["leaf_grads"] = ref.pop("judged")
    nums = check.numbers(prog, ref, cell.update_tolerance)
    correct, lines = check.verdict(nums, cell.limits)

    # ------------------------------ result ---------------------------------
    metrics = {}
    for mdef in cell.per_layer if trace_on else cell.end_to_end:
        v = spec.read_metric(mdef["name"], ctx)
        if v is not None:
            metrics[mdef["name"]] = {"value": v, "unit": mdef["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": ctx.window_dispatches * t["rounds_per_dispatch"],
           "failed": ctx.window_dispatches * t["rounds_per_dispatch"] - ctx.window_rounds,
           "metrics": metrics, "device": dev}
    if trace_on and ctx.profile is not None:
        p = ctx.profile
        dev["busy_s"], dev["window_s"] = p.busy_s, p.span_s
        ops = sorted(p.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        out["breakdown"] = {
            "device_ops": [[name[:200], s] for name, (s, _) in ops],
            "idle_gaps": sorted(([n[:200], s] for n, s in p.gaps.items()),
                                key=lambda x: -x[1])[:10]}
    # strict JSON has no inf or NaN: a number that is not finite is written as its name
    out["checks"] = {n: {"value": nums[n] if math.isfinite(nums[n]) else str(nums[n]),
                         "limit": cell.limits[n]} for n in check.NAMES}
    out["_lines"] = lines
    return out
