#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any mismatch raises and the run exits non-zero):

1. build   — compile every CUDA source of the main path with nvcc (all
             started at once) into build/repro_torch/, print the seconds
             and ptxas' register report.
2. kernels — hold each kernel, through the ops.py wrappers the main path
             calls, against its plain PyTorch version on the card at the
             main path's width (P = 152,783,616) and at a ragged P:
             dp_round (also with acc = theta_bar = 0, which leaves only the
             in-kernel Laplace draw) and sqnorm (also two launches, which
             must be bit-identical).
3. main    — the user's path at full width: DENSE_124M f32, 16 owners x
             10,000 records, eps = 1, batch 4 x seq 128, G = 2 microbatches,
             f32 bank; four run_rounds dispatches of K = 8 timed with the
             host clock (the first warms cuBLAS and the allocator), a fifth
             under torch.profiler (launches per round, device busy time by
             kernel group, the device's idle share), two step() calls,
             reconcile. Launch counts must be K*G sqnorm and K dp_round per
             dispatch.
4. refusal — a reduced model with horizon 2 and schedule-drawn owners:
             the refused mask and reconciled ledger must equal what the
             host computes from the drawn sequence and what the port
             computes on the CPU; theta_L and the bank must agree with the
             CPU run, and a step() loop must equal run_rounds bit for bit.
5. timing  — each kernel (through its ops.py wrapper), its plain version
             and (for sqnorm) torch.dot at the main-path shapes, with CUDA
             events, beside the bound.

Prints a `kernels` JSON line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Without CUDA, or without the
repository beside it, it exits non-zero and prints no result.
"""
import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
P_RAGGED = 1_000_003
ROUND = dict(sigma=1e-2, lr_own=0.3, lr_l=0.2, n_owners=16, theta_max=2.0)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels.dp_clip_noise import kernel
    t0 = time.perf_counter()
    built = _build.build_all({kernel.NAME: kernel.SOURCE})
    print(f"[build] {time.perf_counter() - t0:.2f} s for {sorted(built) or 'nothing'}")
    for name, (sec, out) in built.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        print(f"[build] {name}: nvcc {sec:.2f} s; " + " | ".join(regs))


def phase_kernels(torch, dev):
    from repro_torch import random
    from repro_torch.kernels.dp_clip_noise import kernel, ops, ref
    err = {"dp_round": 0.0, "sqnorm": 0.0}
    before = dict(kernel.launches)
    gen = torch.Generator(device=dev).manual_seed(1)
    scal = [torch.tensor(v, device=dev) for v in (0.5, 0.9, 0.0625)]
    for p in (152_783_616, P_RAGGED):
        key = random.PRNGKey(p, device=dev)
        tb = torch.randn(p, device=dev, generator=gen)
        acc = torch.randn(p, device=dev, generator=gen)
        for a, b, tag in ((tb, acc, "random"), (torch.zeros_like(tb), torch.zeros_like(tb),
                                                 "zero")):
            out = ops.dp_round_flat(a, b, key, *scal, **ROUND)
            plain = ref.dp_round_ref(a, b, random.bits(key, (p,)), *scal, **ROUND)
            for o, r in zip(out, plain):
                torch.testing.assert_close(o, r, rtol=1e-6, atol=1e-6)
                err["dp_round"] = max(err["dp_round"], float((o - r).abs().max()))
            if tag == "zero":
                check(float(out[1].abs().max()) > 0, "zero input gave no noise")
            del out, plain
        s1, s2 = ops.fused_sqnorm(tb), ops.fused_sqnorm(tb)
        check(torch.equal(s1, s2), "two sqnorm launches differ")
        plain = ref.sqnorm_ref(tb)
        torch.testing.assert_close(s1, plain, rtol=1e-5, atol=0.0)
        err["sqnorm"] = max(err["sqnorm"], float((s1 - plain).abs()))
        print(f"[kernels] P={p}: dp_round and sqnorm agree with their plain versions "
              f"(sqnorm {float(s1):.6e} vs {float(plain):.6e})")
        del tb, acc
    got = {k: kernel.launches[k] - before[k] for k in before}
    check(got == {"dp_round": 4, "sqnorm": 4}, f"the wrappers launched {got}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return err


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak_gb(torch, dev):
    return torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")


def _torch_batches(torch, batches):
    return {k: torch.from_numpy(v) for k, v in batches.items()}


def _kernel_group(name):
    low = name.lower()
    if "dp_round" in low:
        return "dp_round kernel"
    if "sqnorm" in low:
        return "sqnorm kernels"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "GEMM"
    return "other"


def _profiled(torch, dev, run, rounds, top=12):
    """run() once under torch.profiler; prints where the device time went
    and returns run()'s result."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = run()
        _sync(torch, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name, calls = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] += e.time_range.elapsed_us() / 1e3
            calls[e.name] += 1
    busy_ms = sum(per_name.values())
    n_launch = sum(calls.values())
    print(f"[profile] {rounds} rounds: wall {wall_ms:.1f} ms with the profiler on, "
          f"device busy {busy_ms:.2f} ms ({busy_ms / rounds:.2f} ms/round), "
          f"{n_launch} device kernels ({n_launch / rounds:.0f}/round)")
    groups = collections.Counter()
    for name, ms in per_name.items():
        groups[_kernel_group(name)] += ms
    for g, ms in groups.most_common():
        print(f"[profile]   {g:16s} {ms / rounds:8.3f} ms/round  {ms / max(busy_ms, 1e-9):6.1%}")
    for name, ms in per_name.most_common(top):
        print(f"[profile]   {ms / rounds:8.3f} ms/round {calls[name] / rounds:6.1f}x/round  "
              f"{name[:100]}")
    return out, busy_ms / rounds


def phase_main(torch, dev, cfg=None, n_owners=16, records=10_000, seq=128, dispatches=4):
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.data import OwnerDataPipeline, synthetic_owner_shards
    from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                        PrivatizerConfig)
    from repro_torch.kernels.dp_clip_noise import kernel
    from repro_torch.models import LM
    cfg = DENSE_124M if cfg is None else cfg
    batch, G, K = 4, 2, 8
    lm = LM(cfg)

    def loss_fn(p, b):
        return lm.loss(p, b)[0]

    t0 = time.perf_counter()
    shards = synthetic_owner_shards(n_owners, records, seq, cfg.vocab, seed=0)
    pipe = OwnerDataPipeline(shards, batch, seed=0)
    owners = [DataOwner(n=s, epsilon=1.0, xi=1.0) for s in pipe.owner_sizes]
    fed = Federation(owners, FederationConfig.from_target_lr(
        0.05, n_owners=n_owners, horizon=1000, sigma=1e-2, theta_max=100.0), device=dev)
    fed.make_step(loss_fn, pack_params=True, privatizer=PrivatizerConfig(
        xi=1.0, granularity="microbatch", n_microbatches=G, fused_kernel=True))
    state = fed.init_state(lm.init(seed=0, device=dev))
    P = state.theta_L.size
    check(P == cfg.param_count(), f"P = {P}")
    held_out = np.random.default_rng(99).integers(0, cfg.vocab, (batch, seq),
                                                  dtype=np.int32)
    eval_batch = _torch_batches(torch, {"tokens": held_out,
                                        "labels": np.roll(held_out, -1, axis=1)})
    eval_batch = {k: v.to(dev) for k, v in eval_batch.items()}
    with torch.no_grad():
        loss0 = float(loss_fn(fed.params_of(state), eval_batch))
    _sync(torch, dev)
    print(f"[main] {cfg.name}: P={P}, bank {tuple(state.bank.shape)} f32 = "
          f"{state.bank.numel() * 4 / 1e9:.3f} GB, set-up {time.perf_counter() - t0:.1f} s, "
          f"central loss before {loss0:.4f}")

    key = random.PRNGKey(0, device=dev)
    kernel.reset_launches()

    def dispatch(state, sub):
        owner_seq = pipe.schedule(K)
        batches = _torch_batches(torch, pipe.batches_for(owner_seq))
        before = dict(kernel.launches)
        state, ms = fed.run_rounds(state, batches, owner_seq, key=sub)
        got = {k: kernel.launches[k] - before[k] for k in before}
        check(got == {"sqnorm": K * G, "dp_round": K}, f"launches {got} in one dispatch")
        check(not bool(ms["refused"].any()), "a round was refused under a long horizon")
        return state, ms, owner_seq, got

    per_round = []
    for d in range(dispatches):
        key, sub = random.split(key)
        _sync(torch, dev)
        t0 = time.perf_counter()
        state, ms, owner_seq, got = dispatch(state, sub)
        _sync(torch, dev)
        dt = (time.perf_counter() - t0) * 1e3
        per_round.append(dt / K)
        print(f"[main] dispatch {d}: K={K} rounds in {dt:.1f} ms ({dt / K:.1f} ms/round), "
              f"owners {owner_seq.tolist()}, launches {got}, "
              f"clip_frac {ms['clip_frac'].mean().item():.2f}")
    # dispatch 0 warms cuBLAS and the allocator
    median = statistics.median(per_round[1:] or per_round)
    print(f"[main] median of dispatches 1..{dispatches - 1}: {median:.2f} ms/round")
    key, sub = random.split(key)
    (state, _, _, _), busy = _profiled(torch, dev, lambda: dispatch(state, sub), K)
    print(f"[profile] device busy {busy:.2f} of the unprofiled median {median:.2f} ms/round: "
          f"the device idles {1 - busy / median:.1%} of a round")
    it = iter(pipe)
    for j in range(2):
        owner, b = next(it)
        key, sub = random.split(key)
        state, m = fed.step(state, b, owner, sub)
        check(not m["refused"], "step refused under a long horizon")
    launches = dict(kernel.launches)
    rounds = (dispatches + 1) * K + 2
    ledger = fed.reconcile(state)
    check(sum(r["responses"] for r in ledger.values()) == rounds, "ledger responses")
    check(sum(r["refused"] for r in ledger.values()) == 0, "ledger refusals")
    check(bool(torch.isfinite(state.theta_L.buf).all())
          and bool(torch.isfinite(state.bank).all()), "non-finite state")
    check(int(state.step) == rounds, "step counter")
    with torch.no_grad():
        loss1 = float(loss_fn(fed.params_of(state), eval_batch))
    check(math.isfinite(loss0) and math.isfinite(loss1), "non-finite loss")
    print(f"[main] central loss {loss0:.4f} -> {loss1:.4f} after {rounds} rounds; "
          f"launches {launches}; peak memory {_peak_gb(torch, dev):.2f} GB")
    print("[main] ledger " + json.dumps(
        {i: [r["responses"], r["refused"], round(r["spent"], 6)]
         for i, r in ledger.items()}))
    del state, fed
    return launches


def phase_refusal(torch, dev):
    from repro_torch import random
    from repro_torch.configs import DENSE_124M
    from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                        PrivatizerConfig)
    from repro_torch.models import LM
    n_owners, horizon, K = 4, 2, 12
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=1, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (K, 4, 16), dtype=np.int32)
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}

    def session(device):
        fed = Federation([DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0)
                          for i in range(n_owners)],
                         FederationConfig.from_target_lr(0.05, n_owners=n_owners,
                                                         horizon=horizon, sigma=1e-2),
                         device=device)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True,
                      privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2,
                                                  fused_kernel=True))
        return fed, fed.init_state(params)

    runs = []
    for device in (dev, torch.device("cpu")):
        fed, state = session(device)
        state, ms = fed.run_rounds(state, _torch_batches(torch, data),
                                   key=random.PRNGKey(21, device=device))
        runs.append((ms["owner"].cpu().numpy(), ms["refused"].cpu().numpy(),
                     fed.reconcile(state), state.theta_L.buf.cpu(), state.bank.cpu()))
    owners, refused, ledger, theta, bank = runs[0]
    counts = np.zeros(n_owners, np.int64)
    expect = []
    for o in owners:
        expect.append(counts[o] >= horizon)
        counts[o] += 1
    check(refused.tolist() == expect, f"refused {refused.tolist()} != host {expect}")
    check(any(expect), "horizon 2 over 12 rounds refused nothing")
    check({i: (r["responses"], r["refused"]) for i, r in ledger.items()}
          == {i: (min(c, horizon), max(c - horizon, 0)) for i, c in enumerate(counts)},
          "reconciled ledger")
    c_owners, c_refused, c_ledger, c_theta, c_bank = runs[1]
    check(np.array_equal(owners, c_owners) and np.array_equal(refused, c_refused)
          and ledger == c_ledger, "cuda and cpu runs disagree on owners/refusals/ledger")
    # f32 sums in other orders (cuBLAS vs the CPU BLAS) around the same keys
    torch.testing.assert_close(theta, c_theta, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(bank, c_bank, rtol=1e-4, atol=1e-5)

    # the host-authorized step loop under the same keys, bit for bit
    fed, state = session(dev)
    round_keys = random.split(random.split(random.PRNGKey(21, device=dev))[1], K)
    for k in range(K):
        state, _ = fed.step(state, {n: torch.from_numpy(v[k]) for n, v in data.items()},
                            int(owners[k]), round_keys[k])
    check(torch.equal(state.theta_L.buf.cpu(), theta) and torch.equal(state.bank.cpu(), bank),
          "step loop differs from run_rounds on the card")
    print(f"[refusal] owners {owners.tolist()} refused {refused.astype(int).tolist()}; "
          f"ledger == host == cpu run; step loop == run_rounds bit for bit; "
          f"max |cuda - cpu| theta {float((theta - c_theta).abs().max()):.3e}")


def phase_timing(torch, dev, launches, errs):
    from repro_torch import random
    from repro_torch.kernels.dp_clip_noise import ops, ref
    P = 152_783_616
    gen = torch.Generator(device=dev).manual_seed(2)
    tb = torch.randn(P, device=dev, generator=gen)
    acc = torch.randn(P, device=dev, generator=gen)
    key = random.PRNGKey(7, device=dev)
    scal = [torch.tensor(v, device=dev) for v in (0.5, 0.9, 0.0625)]
    rows = []
    dp_ms = cuda_ms(torch, lambda: ops.dp_round_flat(tb, acc, key, *scal, **ROUND), 20)
    dp_plain = cuda_ms(torch, lambda: ref.dp_round_ref(
        tb, acc, random.bits(key, (P,)), *scal, **ROUND), 3)
    rows.append(dict(
        name="dp_round", route="cuda",
        source="src/repro_torch/kernels/dp_clip_noise/csrc/dp_clip_noise.cu",
        replaces="src/repro/kernels/dp_clip_noise/kernel.py:129",
        launches=launches["dp_round"], max_abs_err=errs["dp_round"], ms=dp_ms,
        plain_ms=dp_plain, bound_ms=16 * tb.numel() / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None))
    sq_ms = cuda_ms(torch, lambda: ops.fused_sqnorm(tb), 50)
    sq_plain = cuda_ms(torch, lambda: ref.sqnorm_ref(tb), 20)
    sq_lib = cuda_ms(torch, lambda: torch.dot(tb, tb), 50)
    rows.append(dict(
        name="sqnorm", route="cuda",
        source="src/repro_torch/kernels/dp_clip_noise/csrc/dp_clip_noise.cu",
        replaces="src/repro/kernels/dp_clip_noise/kernel.py:146",
        launches=launches["sqnorm"], max_abs_err=errs["sqnorm"], ms=sq_ms,
        plain_ms=sq_plain, bound_ms=4 * tb.numel() / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=sq_lib))
    for r in rows:
        print(f"[timing] {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, "
              f"{r['bound_ms'] / r['ms']:.1%} of it), plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}")
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a "
              "CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    phase_build()
    errs = phase_kernels(torch, dev)
    launches = phase_main(torch, dev)
    torch.cuda.empty_cache()
    check(launches["sqnorm"] > 0 and launches["dp_round"] > 0, "main path launched no kernel")
    phase_refusal(torch, dev)
    rows = phase_timing(torch, dev, launches, errs)
    print(f"[env] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
