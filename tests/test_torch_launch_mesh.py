"""The model zoo's prefill and decode steps on a device mesh, on the CPU;
the mirror of ``tests/test_launch.py``.

For yi-6b, zamba2-2.7b and qwen3-moe-30b-a3b `.reduced()`, at the
reference's SHAPES for prefill and decode, `build_step(cfg, shape, mesh)`:

  (a) on the 1x1 mesh of a gloo world of one equals the unmeshed step BIT
      FOR BIT (prefill logits; a greedy decode's tokens and every step's
      logits, through `greedy_decode(..., step=bundle.step)`);
  (b) on gloo meshes (2, 2), (4, 1) and (1, 4) of four spawned processes
      (one spawn, the three meshes over its four ranks) agrees with the
      unmeshed step within rtol 1e-5 plus 1e-6 of the largest logit: the
      ranks' partial sums add in other orders. The MoE is held to 2^-8 of
      the largest logit instead (its greedy tokens exactly): its onehot
      dispatch rounds x and the combine weights to bf16, as the
      reference's does, so a last-ulp difference upstream can move a value
      by one bf16 step (the bound the port's MoE tests hold it to against
      the reference, tests/test_torch_launch.py);
  (c) the port's dot FLOPs (`analysis.op_cost` over the step's meta stand-
      ins, attn_backend "jnp", one kv chunk) against the reference's walker
      (`repro.analysis.hlo_cost.analyze`) on the reference's step compiled
      on its 1x1 mesh: yi-6b and the MoE equal it (within 1%); the hybrid's
      prefill counts 0.980511 of it, because on meta the port's SSD scan
      takes the kernel route, whose registered formula counts each chunk's
      causal half (Q (Q + 1) / 2 pairs, PERF.md row 9), where the
      reference's plain scan multiplies the whole masked Q x Q block
      (ROADMAP section 3);
  (d) `launch.dryrun.run_one` in a fake world of 256 ranks (a subprocess: a
      fake world cannot share a process) writes a decode and a train
      record, each with ok true, flops > 0 and a dominant term (the train
      step runs on the meshed pytree state: tests/test_torch_train_mesh.py).

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_launch_mesh.py
"""
import dataclasses
import datetime
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import greedy_decode
from repro_torch.launch.steps import build_step, place
from repro_torch.models import build_model

ARCHS = ["yi-6b", "zamba2-2.7b", "qwen3-moe-30b-a3b"]
SHAPES = [ShapeConfig("p", 128, 2, "prefill"), ShapeConfig("d", 128, 4, "decode")]
GLOO_MESHES = [(2, 2), (4, 1), (1, 4)]
PROMPT, GEN = 3, 3


def _inputs(cfg, shape):
    g = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len), generator=g,
                         dtype=torch.int32)
    return toks


def run_step(arch, shape, mesh):
    """The step's outputs as numpy: prefill logits, or a greedy decode's
    (tokens, logits). `mesh` None: the unmeshed twin."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    bundle = build_step(cfg, shape, mesh)
    toks = _inputs(cfg, shape)
    if shape.kind == "prefill":
        args = (params, {"tokens": toks})
        if mesh is not None:
            args = place(bundle.in_shardings, *args)
        out = bundle.step(*args)
        return out.full_tensor().numpy() if mesh is not None else out.numpy()
    cache = model.init_cache(shape.global_batch, shape.seq_len, dtype=torch.float32,
                             device="cpu")
    if mesh is not None:
        params, cache = place(bundle.in_shardings[:2], params, cache)
    seqs, logits = greedy_decode(model, params, cache, toks[:, :PROMPT], GEN,
                                 step=bundle.step)
    return seqs.numpy(), logits.numpy()


@pytest.fixture(scope="module")
def unmeshed():
    torch.set_num_threads(1)
    return {(a, s.kind): run_step(a, s, None) for a in ARCHS for s in SHAPES}


# ------------------------------------------------------------- (a) 1x1 mesh
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.kind)
def test_one_by_one_gloo_mesh_is_bit_exact(arch, shape, unmeshed):
    got = run_step(arch, shape, make_debug_mesh(1, 1, device_type="cpu"))
    want = unmeshed[(arch, shape.kind)]
    for g, w in zip(got if shape.kind == "decode" else (got,),
                    want if shape.kind == "decode" else (want,)):
        np.testing.assert_array_equal(g, w)


# -------------------------------------------------------- (b) gloo meshes
def _worker(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        results = {}
        for shape in GLOO_MESHES:
            mesh = make_debug_mesh(*shape, device_type="cpu")
            for arch in ARCHS:
                for s in SHAPES:
                    results[(shape, arch, s.kind)] = run_step(arch, s, mesh)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zoo_gloo")
    ctx = mp.start_processes(_worker, args=(4, str(tmp / "store"), str(tmp)), nprocs=4,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the gloo meshes did not finish in 600 s")
    runs = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    return runs


@pytest.mark.parametrize("mesh_shape", GLOO_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.kind)
def test_gloo_meshes_agree_with_the_unmeshed_step(mesh_shape, arch, shape, gloo_runs,
                                                  unmeshed):
    want = unmeshed[(arch, shape.kind)]
    for rank in gloo_runs:                      # every rank gathers the same result
        got = rank[(mesh_shape, arch, shape.kind)]
        if shape.kind == "decode":
            np.testing.assert_array_equal(got[0], want[0])      # the greedy tokens
            got, want_l = got[1], want[1]
        else:
            want_l = want
        scale = float(np.abs(want_l).max())
        atol = 2.0 ** -8 * scale if arch == "qwen3-moe-30b-a3b" else 1e-6 * scale
        np.testing.assert_allclose(got, want_l, rtol=1e-5, atol=atol)


# ------------------------------------------------ (c) against the walker
WALKER_RATIO = {("zamba2-2.7b", "prefill"): 0.980511}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.kind)
def test_dot_flops_against_the_reference_walker(arch, shape):
    import jax
    from repro.analysis.hlo_cost import analyze
    from repro.configs import ShapeConfig as JShape, get_config as jget
    from repro.launch.mesh import make_debug_mesh as jmesh
    from repro.launch.steps import build_step as jbuild

    from repro_torch.analysis.op_cost import OpCost

    mesh = jmesh(1, 1)
    jb = jbuild(jget(arch).reduced(), JShape(**dataclasses.asdict(shape)), mesh,
                n_microbatches=2)
    with mesh:
        compiled = jax.jit(jb.step, in_shardings=jb.in_shardings,
                           donate_argnums=jb.donate_argnums).lower(*jb.args).compile()
    want = analyze(compiled.as_text())["flops"]
    tb = build_step(get_config(arch).reduced(), shape, None,
                    model_kw={"attn_backend": "jnp", "kv_chunk": shape.seq_len})
    args = tb.args if shape.kind == "prefill" else tb.args[:3] + (shape.seq_len - 1,)
    with OpCost() as counter:
        tb.step(*args)
    got = counter.summary()["flops"]
    ratio = WALKER_RATIO.get((arch, shape.kind))
    if ratio is None:
        assert abs(got / want - 1.0) < 0.01, (got, want)
    else:
        assert abs(got / want - ratio) < 1e-5, (got / want, ratio)


# --------------------------------------------------- (d) the fake world
_DRYRUN = """
import json, sys
from repro_torch.launch.dryrun import run_one
out = sys.argv[1]
recs = [run_one("yi-6b", s, False, out, reduced=True) for s in ("decode_32k", "train_4k")]
print(json.dumps([{k: r.get(k) for k in ("ok", "error", "chips")} for r in recs]))
"""


def test_dryrun_run_one_in_a_fake_world(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(__file__)), "src"),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _DRYRUN, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, train = json.loads(proc.stdout.strip().splitlines()[-1])
    assert ok["ok"] and ok["chips"] == 256
    assert train["ok"] and train["chips"] == 256, train["error"]
    for shape in ("decode_32k", "train_4k"):
        with open(tmp_path / f"yi-6b__{shape}__pod16x16.json") as f:
            rec = json.load(f)
        assert rec["op_cost"]["flops"] > 0 and rec["trace_s"] >= 0
        assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
        assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
        assert (tmp_path / "trace" / f"yi-6b__{shape}__pod16x16.trace.json.zst").exists()


def test_placements_follow_the_mesh_axes():
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.rules import P, placements
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        placements(P("model", "model"), mesh)
