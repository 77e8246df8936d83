"""The launcher's training step on a device mesh, on the CPU.

For yi-6b, zamba2-2.7b and qwen3-moe-30b-a3b `.reduced()` (the MoE at
moe_mode "onehot": the ragged dispatch raises on a DTensor), f32, at the
reference's train shape ShapeConfig("t", 64, 4, "train") with 2
pre-grouped microbatches, under both privatizers (the reference's
`random.laplace` draw and the fused `sqnorm` / `scale_noise` pass), rounds
of `build_step(cfg, shape, mesh)`:

  (a) on the 1x1 mesh of a gloo world of one, two rounds equal the
      unmeshed step's BIT FOR BIT after each: theta_L, the bank, `step` and
      every metric;
  (b) on gloo meshes (2, 2), (4, 1) and (1, 4) of four spawned processes
      (one spawn, the three meshes over its four ranks), one round agrees
      with the unmeshed step to rtol 1e-4 and atol 1e-6 (the bound
      tests/test_torch_launch.py holds the unmeshed port to against the
      reference): the noise is the unmeshed draw on every mesh, only the
      sums' order differs. Every rank holds only its block of theta_L and
      of the bank (the owner axis whole, the rest its block), and every
      noise draw is the size of a block, never of a whole leaf.

The K-round drivers, the tree, the fault and staleness layers and example
granularity on a meshed pytree state are in tests/test_torch_pytree_mesh*.py.

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_train_mesh.py
"""
import dataclasses
import datetime
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import random
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.federation.deep import init_state
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import build_step, default_async_cfg
from repro_torch.models import build_model
from repro_torch.sharding import rules, spmd
from repro_torch.tree_util import tree_flatten

ARCHS = ["yi-6b", "zamba2-2.7b", "qwen3-moe-30b-a3b"]
FUSED = [False, True]
SHAPE = ShapeConfig("t", 64, 4, "train")
GLOO_MESHES = [(2, 2), (4, 1), (1, 4)]
ROUNDS = 2          # the 1x1 mesh, each round against the unmeshed one
GLOO_ROUNDS = 1     # the gloo meshes
CPU = "cpu"


def _acfg(fused, **kw):
    a = default_async_cfg(n_microbatches=2)
    return dataclasses.replace(a, privatizer=dataclasses.replace(a.privatizer,
                                                                 fused_kernel=fused), **kw)


def _full(t):
    """A copy as numpy (the bank is updated in place by the next round)."""
    return (t.full_tensor() if spmd.is_dtensor(t) else t).detach().numpy().copy()


def run_rounds(arch, mesh, fused, rounds=ROUNDS):
    """`rounds` rounds of the train bundle -> ([after each round: theta_L
    leaves, bank leaves, step, metrics so far] as numpy, the bundle's
    state)."""
    cfg = get_config(arch).reduced()
    acfg = _acfg(fused)
    bundle = build_step(cfg, SHAPE, mesh, n_microbatches=2, dtype=torch.float32, device=CPU,
                        async_cfg=acfg, model_kw={"moe_mode": "onehot"})
    params = build_model(cfg).init(seed=0, device=CPU)
    specs = None if mesh is None else rules.param_specs(params, cfg, mesh)
    state = init_state(params, acfg, device=CPU, mesh=mesh, specs=specs)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, size=(2, SHAPE.global_batch // 2, SHAPE.seq_len),
                        dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=2))}
    key = random.PRNGKey(7, device=CPU)
    metrics, outs = [], []
    for r in range(rounds):
        state, m = bundle.step(state, batch, torch.tensor([2 - r], dtype=torch.int32),
                               random.fold_in(key, r))
        metrics.append({k: _full(v) for k, v in m.items()})
        outs.append({"theta": [_full(x) for x in tree_flatten(state.theta_L)[0]],
                     "bank": [_full(x) for x in tree_flatten(state.bank)[0]],
                     "step": int(_full(state.step)), "metrics": list(metrics)})
    return outs, state


@pytest.fixture(scope="module")
def unmeshed():
    torch.set_num_threads(1)
    return {(a, f): run_rounds(a, None, f)[0] for a in ARCHS for f in FUSED}


def _assert_equal(got, want, exact):
    assert got["step"] == want["step"] == len(want["metrics"])
    for name in ("theta", "bank"):
        assert len(got[name]) == len(want[name])
        for g, w in zip(got[name], want[name]):
            if exact:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    for gm, wm in zip(got["metrics"], want["metrics"]):
        assert sorted(gm) == sorted(wm)
        for k in wm:
            if exact:
                np.testing.assert_array_equal(gm[k], wm[k])
            else:
                np.testing.assert_allclose(gm[k], wm[k], rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------- (a) 1x1 mesh
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fused", FUSED, ids=["laplace", "fused"])
def test_one_by_one_gloo_mesh_is_bit_exact(arch, fused, unmeshed):
    got, state = run_rounds(arch, make_debug_mesh(1, 1, device_type="cpu"), fused)
    assert all(spmd.is_dtensor(x) for x in tree_flatten(state.theta_L)[0]
               + tree_flatten(state.bank)[0])
    for g, w in zip(got, unmeshed[(arch, fused)]):
        _assert_equal(g, w, exact=True)


# -------------------------------------------------------- (b) gloo meshes
def _global_stride(t) -> bool:
    """A DTensor's stride is that of a contiguous tensor of its global
    shape (not its local block's, which differs where a dim is split)."""
    return tuple(t.stride()) == tuple(torch.empty(t.shape, device="meta").stride())


def _blocks_only(state, drawn):
    """Every leaf of theta_L and the bank holds exactly its block (the
    bank: every owner's row of it) and carries its global stride, as does
    an owner's row taken from the bank (theta_i), and the noise of every
    round was drawn leaf by leaf at the size of this rank's block of the
    leaf."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    blocks = []
    for leaf in tree_flatten(state.theta_L)[0]:
        want, _ = compute_local_shape_and_global_offset(leaf.shape, leaf.device_mesh,
                                                        leaf.placements)
        assert tuple(leaf.to_local().shape) == tuple(want)
        assert _global_stride(leaf), (tuple(leaf.shape), leaf.stride())
        blocks.append(int(np.prod(want)))
    for leaf in tree_flatten(state.bank)[0]:
        want, _ = compute_local_shape_and_global_offset(leaf.shape, leaf.device_mesh,
                                                        leaf.placements)
        assert tuple(leaf.to_local().shape) == tuple(want)
        assert want[0] == leaf.shape[0] and not any(p.is_shard(0) for p in leaf.placements)
        assert _global_stride(leaf), (tuple(leaf.shape), leaf.stride())
        row = spmd.take_row(leaf, torch.tensor([2]))
        assert _global_stride(row), (tuple(row.shape), row.stride())
    return drawn == blocks * GLOO_ROUNDS


def _worker(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    from repro_torch.kernels.dp_clip_noise import ops
    drawn = []
    laplace, scale_noise_ref = random.laplace, ops.scale_noise_ref

    def counted_laplace(key, shape=(), *, block=None):
        out = laplace(key, shape, block=block)
        drawn.append(out.numel())
        return out

    def counted_ref(g, bits, *a):
        drawn.append(bits.numel())
        return scale_noise_ref(g, bits, *a)

    random.laplace, ops.scale_noise_ref = counted_laplace, counted_ref
    try:
        results = {}
        for shape in GLOO_MESHES:
            mesh = make_debug_mesh(*shape, device_type="cpu")
            for arch in ARCHS:
                for fused in FUSED:
                    drawn.clear()
                    outs, state = run_rounds(arch, mesh, fused, GLOO_ROUNDS)
                    out = outs[-1]
                    out["blocks_only"] = bool(drawn) and _blocks_only(state, drawn)
                    results[(shape, arch, fused)] = out
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        random.laplace, ops.scale_noise_ref = laplace, scale_noise_ref
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_gloo")
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
@pytest.mark.parametrize("fused", FUSED, ids=["laplace", "fused"])
def test_gloo_meshes_agree_with_the_unmeshed_step(mesh_shape, arch, fused, gloo_runs,
                                                 unmeshed):
    want = unmeshed[(arch, fused)][GLOO_ROUNDS - 1]
    for rank in gloo_runs:                      # every rank gathers the same result
        _assert_equal(rank[(mesh_shape, arch, fused)], want, exact=False)


@pytest.mark.parametrize("mesh_shape", GLOO_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gloo_ranks_hold_only_their_blocks(mesh_shape, gloo_runs):
    for rank in gloo_runs:
        for arch in ARCHS:
            for fused in FUSED:
                assert rank[(mesh_shape, arch, fused)]["blocks_only"], (arch, fused)


def test_init_state_on_a_mesh_needs_the_specs():
    cfg = get_config("yi-6b").reduced()
    params = build_model(cfg).init(seed=0, device=CPU)
    with pytest.raises(ValueError, match="specs"):
        init_state(params, _acfg(False), device=CPU,
                   mesh=make_debug_mesh(1, 1, device_type="cpu"))
