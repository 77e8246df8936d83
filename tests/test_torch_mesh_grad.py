"""The model zoo's loss gradient on a device mesh, on the CPU.

For each family at its reduced config (yi-6b, qwen3-moe-30b-a3b onehot,
zamba2-2.7b, xlstm-125m, internvl2-2b, whisper-medium), remat on, B 4 x
S 64, the parameters placed by `rules.param_specs` and the batch by
`rules.batch_specs`, the loss and the gradient of every leaf (by
`dp_sgd._tree_grad`, the round's autograd, which hands each gradient back
in its parameter's placements):

  * on the 1x1 mesh of a gloo world of one equal the unmeshed ones BIT
    FOR BIT;
  * on gloo meshes (2, 2), (4, 1) and (1, 4) of four spawned processes
    (one spawn) agree with them within 1e-4 of the leaf's largest
    |gradient|, the bound the port's gradient tests hold it to against the
    reference (tests/test_torch_hybrid.py), and the MoE within 2^-8 of it
    (its onehot dispatch rounds to bf16, the bound
    tests/test_torch_launch_mesh.py holds its forward to); every gradient
    laid out as its parameter.

That covers the backward of `spmd.einsum` (an operand replicated over a
mesh dim the product splits gets a partial gradient), `spmd.embedding`
(the vocab-parallel lookup: each token's gradient lands in the rows its
rank holds), `spmd.local_map` (the SSD scans' Bm/Cm, which have no head
dim, the sLSTM loop's and the attention's replicated inputs) and
`spmd.cross_entropy` (the loss over vocab-sharded logits).

On the production mesh (16, 16) of a fake world of 256 ranks (a
subprocess: meta tensors, nothing allocated), the launcher's train step
runs for the reduced xlstm-125m (4 mLSTM heads, which the model axis does
not divide) and zamba2-2.7b: a gradient that reaches a head merge sharded where the
forward tensor was replicated is laid out again first
(`spmd.keep_grad_layout`), which the merge's backward needs.

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_mesh_grad.py
"""
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
from repro_torch.federation.dp_sgd import _tree_grad
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import LM
from repro_torch.sharding import rules, spmd
from repro_torch.tree_util import tree_flatten

ARCHS = ["yi-6b", "qwen3-moe-30b-a3b", "zamba2-2.7b", "xlstm-125m", "internvl2-2b",
         "whisper-medium"]
GLOO_MESHES = [(2, 2), (4, 1), (1, 4)]
B, S = 4, 64


def loss_and_grads(arch, mesh):
    """(loss, [gradient of each leaf], whether each gradient is laid out as
    its parameter) as numpy."""
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    params = lm.init(seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(B, cfg.n_patches, cfg.d_model, generator=g)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(B, cfg.enc_seq, cfg.d_model, generator=g)
    if mesh is not None:
        params = rules.distribute(params, rules.param_specs(params, cfg, mesh), mesh)
        batch = rules.distribute(batch, rules.batch_specs(batch, ShapeConfig("t", S, B, "train"),
                                                          mesh), mesh)
    losses = []

    def loss_fn(p, b):
        losses.append(lm.loss(p, b)[0])
        return losses[-1]
    grads = tree_flatten(_tree_grad(loss_fn, params, batch))[0]

    def full(t):
        return (t.full_tensor() if spmd.is_dtensor(t) else t).detach().numpy()
    laid = [not spmd.is_dtensor(gr) or gr.placements == x.placements
            for gr, x in zip(grads, tree_flatten(params)[0])]
    return full(losses[0]), [full(gr) for gr in grads], laid


@pytest.fixture(scope="module")
def unmeshed():
    torch.set_num_threads(1)
    return {a: loss_and_grads(a, None) for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_gloo_mesh_gradient_is_bit_exact(arch, unmeshed):
    loss, grads, _ = loss_and_grads(arch, make_debug_mesh(1, 1, device_type="cpu"))
    want_loss, want, _ = unmeshed[arch]
    np.testing.assert_array_equal(loss, want_loss)
    for g, w in zip(grads, want):
        np.testing.assert_array_equal(g, w)


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
                results[(shape, arch)] = loss_and_grads(arch, mesh)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grad_gloo")
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
def test_gloo_mesh_gradients_agree_with_the_unmeshed_ones(mesh_shape, arch, gloo_runs,
                                                          unmeshed):
    want_loss, want, _ = unmeshed[arch]
    rel = 2.0 ** -8 if arch == "qwen3-moe-30b-a3b" else 1e-4
    for rank in gloo_runs:
        loss, grads, laid = rank[(mesh_shape, arch)]
        assert all(laid)
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert len(grads) == len(want)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=rel * float(np.abs(w).max()) + 1e-12)


_FAKE_WORLD = """
import json, sys
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.steps import build_step
fake_world(256)
mesh = make_production_mesh(device_type="cpu")
out = {}
for arch in ("xlstm-125m", "zamba2-2.7b"):
    cfg = get_config(arch).reduced()
    bundle = build_step(cfg, ShapeConfig("t", 64, 32, "train"), mesh, n_microbatches=2,
                        device="meta")
    state, _ = bundle.step(*bundle.args)
    out[arch] = tuple(state.step.shape)
from repro_torch.models.xlstm import mlstm_dims
out["mlstm_heads"] = mlstm_dims(get_config("xlstm-125m").reduced())[1]
print(json.dumps(out))
"""


def test_train_step_in_a_fake_production_world_with_undivided_heads(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(__file__)), "src"),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _FAKE_WORLD], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["xlstm-125m"] == out["zamba2-2.7b"] == []      # both rounds ran
    assert out["mlstm_heads"] % 16                            # "model" splits no mLSTM head
