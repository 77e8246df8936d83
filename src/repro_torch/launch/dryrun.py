"""Multi-pod dry-run: every (arch x input shape x mesh) traced on meta
tensors in a fake world, with its per-device cost and roofline terms.

The counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each step against ShapeDtypeStructs on 512 placeholder devices;
here the step is built on meta tensors (`launch.steps.build_step` with a
production mesh over a fake world of 512 ranks, this process rank 0:
`launch.mesh.fake_world`), run once under `analysis.op_cost.OpCost`,
which counts what rank 0 computes on its local pieces, and costed by
`analysis.roofline` with an H100's peaks. Nothing is allocated or
launched, so it runs on the CPU, and it is its own process: a fake world
cannot share one with a real world (the reference's dry-run is its own
process too, for its XLA_FLAGS).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Records land in results/dryrun/<arch>__<shape>__<mesh>.json with the
reference's fields, except that `trace_s` (the traced run's seconds)
stands for `lower_s` / `compile_s`, the cost is under "op_cost" (the
walker's keys), and `memory_analysis` holds the per-device bytes of the
arguments and the outputs and, as `temp_size_in_bytes`, the peak of the
live bytes the counter tracked. The trace is saved beside them
(trace/<tag>.trace.json.zst) for `analysis.reanalyze`; `analysis.report`
prints the tables. `params` and `active_params` are the port's counts of
every leaf `LM.init` makes (`configs/base.py`); ROADMAP section 3 lists
how they differ from the reference's formula.

A train shape runs one round of `build_train_step` on the meshed pytree
state (theta_L and the owner bank as meta DTensors, the round's own
constants on meta too): every microbatch's forward, its backward and,
with the model's remat on (the default, as in the reference;
`--remat-groups` is the reference's knob), the backward's recompute are
counted, as are the privatizer's block-by-block noise draws. A decode
step runs at the last position of the cache (its cost does not depend on
the position).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.analysis.op_cost import OpCost
from repro_torch.analysis.roofline import flops_by_dtype, model_flops, roofline_terms
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.tree_util import tree_flatten

PARAMS_NOTE = ("the port's count of every leaf LM.init makes (configs/base.py); "
               "ROADMAP section 3 lists how it differs from the reference's formula")


def _local_bytes(tree) -> int:
    """The bytes this rank holds of every tensor of `tree`."""
    total = 0
    for t in tree_flatten(tree)[0]:
        if hasattr(t, "to_local"):
            t = t.to_local()
        if hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
    return total


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            skip_existing: bool = False, variant: str = "", step_kw: dict = None,
            reduced: bool = False) -> dict:
    """One record (the reference's `run_one`); `reduced` takes the arch's
    reduced config (for tests)."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    if variant:
        tag += f"__{variant}"
    path = os.path.join(out_dir, tag + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False,
           "variant": variant, "reduced": reduced,
           "step_kw": {k: v for k, v in (step_kw or {}).items()}}
    try:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        chips = mesh.size()
        # a train step's own constants (the owners' scales and weights) on meta too
        bundle = build_step(cfg, shape, mesh, **{"device": "meta", **(step_kw or {})})
        args = bundle.args
        if bundle.kind == "decode":
            args = args[:3] + (shape.seq_len - 1,)
        t0 = time.time()
        with OpCost() as counter:
            out = bundle.step(*args)
        rec["trace_s"] = round(time.time() - t0, 2)
        mem = {"argument_size_in_bytes": _local_bytes(args),
               "output_size_in_bytes": _local_bytes(out),
               "temp_size_in_bytes": counter.peak_live_bytes}
        rec["memory_analysis"] = mem
        print(f"[{tag}] memory_analysis: {mem}")

        os.makedirs(os.path.join(out_dir, "trace"), exist_ok=True)
        counter.save(os.path.join(out_dir, "trace", tag + ".trace.json.zst"))
        walked = counter.summary()
        rec["op_cost"] = walked
        flops = walked["flops"]
        byts = walked["traffic_bytes"]
        coll_total = walked["collective_bytes_total"]
        print(f"[{tag}] op_cost: flops={flops:.3e} traffic={byts:.3e} "
              f"coll={coll_total:.3e}")

        rec["roofline"] = record_roofline(cfg, shape, walked, chips)
        rec["chips"] = chips
        rec["params"] = cfg.param_count()
        rec["active_params"] = cfg.active_param_count()
        rec["params_note"] = PARAMS_NOTE
        rec["ok"] = True
        print(f"[{tag}] roofline: {rec['roofline']}")
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[{tag}] FAILED: {rec['error']}")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def record_roofline(cfg, shape, walked: dict, chips: int) -> dict:
    """The roofline section of a record from its op_cost section."""
    flops = walked["flops"]
    terms = roofline_terms(flops, walked["traffic_bytes"], walked["collective_bytes_total"],
                           flops_by_dtype(walked))
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = model_flops(cfg.active_param_count(), tokens,
                     "train" if shape.kind == "train" else "infer")
    terms["model_flops_total"] = mf
    terms["counted_flops_total"] = flops * chips
    terms["useful_flops_ratio"] = mf / (flops * chips) if flops else 0.0
    return terms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every (arch x shape)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="", help="tag suffix for A/B runs")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--moe-mode", default="onehot", choices=["onehot", "ragged"])
    ap.add_argument("--moe-group-tokens", type=int, default=512)
    ap.add_argument("--kv-chunk", type=int, default=1024)
    ap.add_argument("--attn-backend", default="jnp", choices=["jnp", "pallas"])
    ap.add_argument("--remat-groups", type=int, default=0,
                    help="nested remat: checkpoint groups of layers (0 = per layer)")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = sorted(INPUT_SHAPES) if args.all or not args.shape else [args.shape]
    step_kw = {"n_microbatches": args.microbatches,
               "model_kw": {"moe_mode": args.moe_mode,
                            "moe_group_tokens": args.moe_group_tokens,
                            "kv_chunk": args.kv_chunk,
                            "attn_backend": args.attn_backend,
                            "remat_groups": args.remat_groups}}
    fake_world(512 if any(meshes) else 256)

    n_ok = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_one(arch, shape, mp, args.out, skip_existing=args.skip_existing,
                              variant=args.variant, step_kw=step_kw)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
