"""A pytree state on gloo meshes (2, 2), (4, 1) and (1, 4) of four
spawned processes (ONE spawn; the three meshes over its four ranks),
against the unmeshed port, on the CPU.

With the cases of tests/_pytree_mesh.py on the reduced yi-6b (four owners,
K = 4 rounds):

  (a) `make_fused_rounds` under the tree at depth 2 (the reference's
      `random.laplace` privatizer), `make_group_rounds` under the fault
      layer with the staleness runtime (the fused `sqnorm` /
      `scale_noise` privatizer), and one `make_train_step` round at example
      granularity (fused): the floats agree with the unmeshed run to rtol
      1e-4 and atol 1e-6 (example granularity: plus 1e-5 of the array's
      largest magnitude), only the sums' order differing; the owners, the
      refusals, the ledger, the leaf counts and the fault and runtime
      columns exactly. A row checksum sums the row's bits, so it equals the
      unmeshed one exactly where the meshed row's bits do (the rows no
      granted round wrote); every stored checksum equals `bank_checksums`
      of the meshed bank itself;
  (b) every rank holds only its blocks: theta_L its block of each leaf,
      the bank (N, *block), the nodes (N, d, *block), and every noise draw
      of the dispatch is the size of this rank's block of a leaf, never of
      a whole leaf;
  (c) a property of the checksums: `faults.bank_checksums` of a bank of
      DTensor leaves equals the unmeshed bank's bit for bit, over seeded
      random banks of f32 and bf16 leaves, each leaf sharded on one or two
      of its dims or replicated over one mesh dim or both.

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_pytree_mesh_gloo.py
"""
import datetime
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _pytree_mesh import Arch, assert_same, run_case
from repro_torch import random
from repro_torch.federation import faults
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.sharding import rules
from repro_torch.tree_util import tree_flatten

GLOO_MESHES = [(2, 2), (4, 1), (1, 4)]
CASES = [("fused", "tree", False, False), ("group", "stale", True, False),
         ("train", "plain", True, True)]
CASE_IDS = ["fused-tree-laplace", "group-stale-fused", "train-example-fused"]
N_BANKS = 6          # random banks a mesh for the checksum property


def _random_bank(seed: int, mesh_shape):
    """A seeded random bank: (leaf name -> ((N, *shape) tensor, the leaf's
    placements on a mesh of `mesh_shape`))."""
    from torch.distributed.tensor import Replicate, Shard
    rng = np.random.default_rng(seed)
    out = {}
    for j in range(int(rng.integers(2, 5))):
        shape = tuple(int(d) * 4 for d in rng.integers(1, 4, size=int(rng.integers(1, 4))))
        dtype = torch.float32 if rng.random() < 0.6 else torch.bfloat16
        rows = torch.from_numpy(rng.standard_normal((3,) + shape).astype(np.float32)).to(dtype)
        place = []
        for m in range(2):
            # Shard a dim of the leaf (the bank's dim + 1), or replicate
            d = int(rng.integers(-1, len(shape)))
            taken = {p.dim for p in place if p.is_shard()}
            place.append(Replicate() if d < 0 or d + 1 in taken or shape[d] % mesh_shape[m]
                         else Shard(d + 1))
        out[f"leaf{j}"] = (rows, place)
    return out


def _meshed_checksums(mesh, mesh_shape):
    from torch.distributed.tensor import distribute_tensor
    sums = []
    for b in range(N_BANKS):
        bank = {k: distribute_tensor(rows, mesh, place)
                for k, (rows, place) in _random_bank(b, mesh_shape).items()}
        sums.append(faults.bank_checksums(bank).numpy().copy())
    return sums


def _blocks_only(state, drawn, cfg):
    """Each rank holds its block of every leaf of theta_L, (N, *block) of
    the bank, (N, d, *block) of the nodes, laid out as
    `rules.param_specs(..., node_axes=True)` says; the draws are blocks."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    blocks = []
    for leaf, bank in zip(tree_flatten(state.theta_L)[0], tree_flatten(state.bank)[0]):
        want, _ = compute_local_shape_and_global_offset(leaf.shape, leaf.device_mesh,
                                                        leaf.placements)
        want = tuple(want)
        assert tuple(leaf.to_local().shape) == want
        assert tuple(bank.to_local().shape) == (bank.shape[0],) + want
        blocks.append(int(np.prod(want)))
    if state.tree is not None:
        mesh = tree_flatten(state.theta_L)[0][0].device_mesh
        node_specs = rules._spec_leaves(rules.param_specs(state.tree.nodes, cfg, mesh,
                                                          node_axes=True))
        for nodes, spec in zip(tree_flatten(state.tree.nodes)[0], node_specs):
            assert tuple(nodes.placements) == tuple(rules.placements(spec, mesh))
        for leaf, nodes in zip(tree_flatten(state.theta_L)[0],
                               tree_flatten(state.tree.nodes)[0]):
            want, _ = compute_local_shape_and_global_offset(leaf.shape, leaf.device_mesh,
                                                            leaf.placements)
            assert tuple(nodes.to_local().shape) == tuple(nodes.shape[:2]) + tuple(want)
    return sorted(drawn) == sorted(blocks * (len(drawn) // len(blocks))) and drawn


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
        archs = {False: Arch("yi-6b"), True: Arch("yi-6b", example=True)}
        results = {}
        for shape in GLOO_MESHES:
            mesh = make_debug_mesh(*shape, device_type="cpu")
            for (driver, form, fused, example), cid in zip(CASES, CASE_IDS):
                drawn.clear()
                outs, state = run_case(archs[example], driver, form, fused, mesh,
                                       example=example, k=1 if example else 4)
                results[(shape, cid)] = outs
                results[(shape, cid, "blocks")] = bool(_blocks_only(state, list(drawn),
                                                                    archs[example].cfg))
                if state.faults is not None:
                    results[(shape, cid, "checksums")] = faults.bank_checksums(
                        state.bank).numpy().copy()
            results[(shape, "checksums")] = _meshed_checksums(mesh, shape)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        random.laplace, ops.scale_noise_ref = laplace, scale_noise_ref
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pytree_gloo")
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


@pytest.fixture(scope="module")
def unmeshed(gloo_runs):
    torch.set_num_threads(1)
    archs = {False: Arch("yi-6b"), True: Arch("yi-6b", example=True)}
    return {cid: run_case(archs[ex], d, f, z, None, example=ex, k=1 if ex else 4)[0]
            for (d, f, z, ex), cid in zip(CASES, CASE_IDS)}


def _assert_example_close(got, want):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            gs, ws = (g[name], w[name]) if isinstance(w[name], list) else ([g[name]], [w[name]])
            for a, b in zip(gs, ws):
                if np.issubdtype(b.dtype, np.floating) and name != "metric.clip_frac":
                    big = float(np.abs(b).max()) if b.size else 0.0
                    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 + 1e-5 * big,
                                               err_msg=name)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("mesh_shape", GLOO_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("cid", CASE_IDS)
def test_gloo_meshes_agree_with_the_unmeshed_port(mesh_shape, cid, gloo_runs, unmeshed):
    want = unmeshed[cid]
    for rank in gloo_runs:                      # every rank gathers the same result
        got = rank[(mesh_shape, cid)]
        if cid.startswith("train-example"):
            _assert_example_close(got, want)
            continue
        assert_same(got, want, exact=False, skip=("faults.checksum",))
        if "faults.checksum" not in want[-1]:
            continue
        stored = got[-1]["faults.checksum"]
        np.testing.assert_array_equal(stored, rank[(mesh_shape, cid, "checksums")])
        same_bits = np.array([all(np.array_equal(g[i], w[i]) for g, w in
                                  zip(got[-1]["bank"], want[-1]["bank"]))
                              for i in range(len(stored))])
        assert same_bits.sum() >= 2
        np.testing.assert_array_equal(stored[same_bits], want[-1]["faults.checksum"][same_bits])


@pytest.mark.parametrize("mesh_shape", GLOO_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gloo_ranks_hold_only_their_blocks(mesh_shape, gloo_runs):
    for rank in gloo_runs:
        for cid in CASE_IDS:
            assert rank[(mesh_shape, cid, "blocks")], cid


@pytest.mark.parametrize("mesh_shape", GLOO_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_bank_checksums_equal_the_unmeshed_bank_on_every_mesh(mesh_shape, gloo_runs):
    from torch.distributed.tensor import Replicate
    replicated_leaves = 0
    for b in range(N_BANKS):
        bank = _random_bank(b, mesh_shape)
        want = faults.bank_checksums({k: rows for k, (rows, _) in bank.items()}).numpy()
        replicated_leaves += sum(any(isinstance(p, Replicate) for p in place)
                                 for _, place in bank.values())
        for rank in gloo_runs:
            np.testing.assert_array_equal(rank[(mesh_shape, "checksums")][b], want)
    assert replicated_leaves > 0
