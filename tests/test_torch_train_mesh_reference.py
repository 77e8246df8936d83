"""The launcher's meshed training step against the reference's, on the CPU.

The reference's `build_train_step(jcfg, shape, make_debug_mesh(1, 1),
dtype=float32)`, jitted with its `in_shardings` and `donate_argnums`,
against the port's `build_step(cfg, shape, mesh)` on the 1x1 mesh of a
gloo world of one: the same converted weights, the same microbatch-major
batch, owner 2 and the key PRNGKey(7), for the reduced yi-6b, zamba2-2.7b
and qwen3-moe-30b-a3b (onehot), each with its model's remat on, as the
reference's launcher builds it. theta_L and the bank agree to rtol 1e-4
and atol 1e-6, the bound tests/test_torch_launch.py holds the unmeshed
step to; `step` and clip_frac are equal.

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_train_mesh_reference.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShape, get_config as jget_config
from repro.federation.deep import init_state as jinit_state
from repro.launch.mesh import make_debug_mesh as jmesh
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.launch.steps import default_async_cfg as jdefault_async_cfg
from repro.models import build_model as jax_build_model
from repro_torch import random
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.federation.deep import init_state
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import build_step, default_async_cfg
from repro_torch.sharding import rules, spmd
from repro_torch.tree_util import tree_flatten

CPU = "cpu"
SHAPE = ShapeConfig("t", 64, 4, "train")


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-2.7b", "qwen3-moe-30b-a3b"])
def test_meshed_step_agrees_with_the_reference_meshed_step(arch):
    torch.set_num_threads(1)
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jacfg, acfg = jdefault_async_cfg(n_microbatches=2), default_async_cfg(n_microbatches=2)
    mesh = jmesh(1, 1)
    jb = jbuild_train_step(jcfg, JShape("t", 64, 4, "train"), mesh, async_cfg=jacfg,
                           dtype=jnp.float32)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(4), jnp.float32)
    # before the jitted step, which donates the state (theta_L is jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, size=(2, SHAPE.global_batch // 2, SHAPE.seq_len),
                        dtype=np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    with mesh:
        step = jax.jit(jb.step, in_shardings=jb.in_shardings, donate_argnums=jb.donate_argnums)
        js, jm = step(jinit_state(jparams, jacfg), {k: jnp.asarray(v) for k, v in batch.items()},
                      jnp.int32(2), jax.random.key_data(jax.random.PRNGKey(7)))

    tmesh = make_debug_mesh(1, 1, device_type="cpu")
    tb = build_step(cfg, SHAPE, tmesh, n_microbatches=2, dtype=torch.float32, device=CPU,
                    async_cfg=acfg)
    state = init_state(params, acfg, device=CPU, mesh=tmesh,
                       specs=rules.param_specs(params, cfg, tmesh))
    ts, tm = tb.step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                     torch.tensor([2], dtype=torch.int32), random.PRNGKey(7, device=CPU))

    def full(t):
        return (t.full_tensor() if spmd.is_dtensor(t) else t).detach().numpy()
    assert int(full(ts.step)) == int(js.step) == 1
    assert float(full(tm["clip_frac"])) == float(jm["clip_frac"])
    np.testing.assert_allclose(full(tm["max_grad_norm"]), np.asarray(jm["max_grad_norm"]),
                               rtol=1e-4)
    got = tree_flatten(ts.theta_L)[0] + tree_flatten(ts.bank)[0]
    want = jax.tree_util.tree_leaves(js.theta_L) + jax.tree_util.tree_leaves(js.bank)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(full(a), np.asarray(b), rtol=1e-4, atol=1e-6)
