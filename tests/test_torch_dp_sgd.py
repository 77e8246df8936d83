"""The port's pytree privatizer (repro_torch.federation.dp_sgd) against the
reference's (repro.federation.dp_sgd), on the CPU.

`private_grad` runs on the same params, batch and key in both packages,
in both granularities ('example' through torch.func.vmap(grad),
'microbatch' as a loop over the groups, also pre-grouped), both backends
(the jnp-equivalent draw, and fused_kernel=True, whose reference side runs
its kernels' jnp oracles), the Laplace and the Gaussian mechanism, and
with return_noise; on a toy MLP and on the reduced dense LM. Tolerances:
the gradients come from two autodiff systems and the norms sum in other
orders, so the noisy gradient agrees within rtol 1e-4 and atol 1e-6 (the
Gaussian draw adds erfinv's rtol 1e-4 times the noise scale), the max
gradient norm within rtol 1e-5, the clip fraction exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.federation import dp_sgd as jdp
from repro.models import build_model as jax_build_model
from repro_torch import random as trandom
from repro_torch.configs.base import DENSE_124M
from repro_torch.convert import params_from_numpy
from repro_torch.federation import dp_sgd as tdp
from repro_torch.models import LM
from repro_torch.tree_util import tree_flatten

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------- a toy MLP ----------------------------------
def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((5, 8)).astype(np.float32) * 0.7,
            "b1": rng.standard_normal(8).astype(np.float32) * 0.1,
            "w2": rng.standard_normal(8).astype(np.float32),
            "b2": np.float32(0.3)}


def _mlp_batch(B=8, seed=1):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((B, 5)).astype(np.float32),
            "y": rng.standard_normal(B).astype(np.float32)}


def _jax_mlp_loss(p, b):
    h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] + p["b2"] - b["y"]) ** 2)


def _torch_mlp_loss(p, b):
    h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] + p["b2"] - b["y"]) ** 2)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(t_tree, j_tree, rtol=RTOL, atol=ATOL):
    t_leaves = tree_flatten(t_tree)[0]
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _both(jloss, tloss, jparams, tparams, batch, key_seed, ns, **cfg_kw):
    jcfg, tcfg = jdp.PrivatizerConfig(**cfg_kw), tdp.PrivatizerConfig(**cfg_kw)
    jout = jax.jit(lambda p, b, k, s: jdp.private_grad(jloss, p, b, k, cfg=jcfg, noise_scale=s))(
        jparams, _to_jax(batch), jax.random.PRNGKey(key_seed), jnp.float32(ns))
    tout = tdp.private_grad(tloss, tparams, _to_torch(batch),
                            trandom.PRNGKey(key_seed, device=CPU), cfg=tcfg,
                            noise_scale=torch.tensor(ns))
    return jout, tout


def _check_metrics(tm, jm):
    assert float(tm["clip_frac"]) == float(jm["clip_frac"])
    np.testing.assert_allclose(float(tm["max_grad_norm"]), float(jm["max_grad_norm"]),
                               rtol=1e-5)


@pytest.mark.parametrize("mechanism,fused", [("laplace", False), ("laplace", True),
                                             ("gaussian", False)])
@pytest.mark.parametrize("granularity", ["example", "microbatch"])
@pytest.mark.parametrize("xi", [0.5, 100.0])
def test_private_grad_on_a_toy_mlp_matches_reference(granularity, mechanism, fused, xi):
    params, batch, ns = _mlp_params(), _mlp_batch(), 0.05
    kw = dict(xi=xi, granularity=granularity, n_microbatches=4, mechanism=mechanism,
              fused_kernel=fused)
    (jq, jm), (tq, tm) = _both(_jax_mlp_loss, _torch_mlp_loss, _to_jax(params),
                               _to_torch(params), batch, 3, ns, **kw)
    _check_metrics(tm, jm)
    atol = ATOL + (1e-4 * 4.5 * ns if mechanism == "gaussian" else 0.0)
    _close(tq, jq, atol=atol)
    assert float(tm["clip_frac"]) == (1.0 if xi == 0.5 else 0.0)


def test_pre_grouped_batch_matches_reference_and_the_flat_batch():
    params, batch, ns = _mlp_params(1), _mlp_batch(seed=2), 0.05
    grouped = {k: v.reshape((4, 2) + v.shape[1:]) for k, v in batch.items()}
    kw = dict(xi=0.5, n_microbatches=4, pre_grouped=True)
    (jq, jm), (tq, tm) = _both(_jax_mlp_loss, _torch_mlp_loss, _to_jax(params),
                               _to_torch(params), grouped, 4, ns, **kw)
    _check_metrics(tm, jm)
    _close(tq, jq)
    flat, _ = tdp.private_grad(_torch_mlp_loss, _to_torch(params), _to_torch(batch),
                               trandom.PRNGKey(4, device=CPU),
                               cfg=tdp.PrivatizerConfig(xi=0.5, n_microbatches=4),
                               noise_scale=torch.tensor(ns))
    for a, b in zip(tree_flatten(tq)[0], tree_flatten(flat)[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mechanism", ["laplace", "gaussian"])
def test_return_noise_matches_reference(mechanism):
    params, batch, ns = _mlp_params(2), _mlp_batch(seed=3), 0.2
    jcfg = jdp.PrivatizerConfig(xi=0.5, n_microbatches=2, mechanism=mechanism)
    tcfg = tdp.PrivatizerConfig(xi=0.5, n_microbatches=2, mechanism=mechanism)
    jq, jm, jn = jdp.private_grad(_jax_mlp_loss, _to_jax(params), _to_jax(batch),
                                  jax.random.PRNGKey(5), cfg=jcfg, noise_scale=ns,
                                  return_noise=True)
    tq, tm, tn = tdp.private_grad(_torch_mlp_loss, _to_torch(params), _to_torch(batch),
                                  trandom.PRNGKey(5, device=CPU), cfg=tcfg, noise_scale=ns,
                                  return_noise=True)
    noise_atol = 1e-4 * 4.5 * ns if mechanism == "gaussian" else 1e-7
    _close(tn, jn, rtol=1e-4, atol=noise_atol)
    _close(tq, jq, atol=ATOL + noise_atol)
    # the draw is the one the response carries, unchanged by returning it
    plain, _ = tdp.private_grad(_torch_mlp_loss, _to_torch(params), _to_torch(batch),
                                trandom.PRNGKey(5, device=CPU), cfg=tcfg, noise_scale=ns)
    for a, b in zip(tree_flatten(tq)[0], tree_flatten(plain)[0]):
        assert torch.equal(a, b)


def test_return_noise_under_fused_kernel_raises_like_reference():
    params, batch = _mlp_params(), _mlp_batch()
    msgs = []
    for mod, loss, conv, key in (
            (jdp, _jax_mlp_loss, _to_jax, jax.random.PRNGKey(0)),
            (tdp, _torch_mlp_loss, _to_torch, trandom.PRNGKey(0, device=CPU))):
        with pytest.raises(ValueError) as err:
            mod.private_grad(loss, conv(params), conv(batch), key,
                             cfg=mod.PrivatizerConfig(xi=1.0, fused_kernel=True),
                             noise_scale=1.0, return_noise=True)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="laplace mechanism"):
        tdp.private_grad(_torch_mlp_loss, _to_torch(params), _to_torch(batch),
                         trandom.PRNGKey(0, device=CPU),
                         cfg=tdp.PrivatizerConfig(xi=1.0, n_microbatches=2,
                                                  mechanism="gaussian", fused_kernel=True),
                         noise_scale=1.0)


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
def test_clip_tree_matches_reference(max_norm):
    tree = _mlp_params(3)
    tc, tnorm = tdp.clip_tree(_to_torch(tree), max_norm)
    jc, jnorm = jdp.clip_tree(_to_jax(tree), max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(float(tdp._global_norm(_to_torch(tree))),
                               float(jdp._global_norm(_to_jax(tree))), rtol=1e-6)
    _close(tc, jc, rtol=1e-6, atol=0)


# ------------------------------ the reduced dense LM -------------------------------
JAX_REDUCED = JaxModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab=50304).reduced()


@pytest.fixture(scope="module")
def lm_case():
    jlm = jax_build_model(JAX_REDUCED, remat=False)
    jparams = jlm.init(jax.random.PRNGKey(1))
    lm = LM(DENSE_124M.reduced())
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    toks = np.random.default_rng(2).integers(0, JAX_REDUCED.vocab, size=(4, 16),
                                             dtype=np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    return (lambda p, b: jlm.loss(p, b)[0], jparams,
            lambda p, b: lm.loss(p, b)[0], tparams, batch)


@pytest.mark.parametrize("granularity,fused", [("microbatch", False), ("microbatch", True),
                                               ("example", False)])
def test_private_grad_on_the_reduced_lm_matches_reference(lm_case, granularity, fused):
    jloss, jparams, tloss, tparams, batch = lm_case
    kw = dict(xi=1.0, granularity=granularity, n_microbatches=2, fused_kernel=fused)
    (jq, jm), (tq, tm) = _both(jloss, tloss, jparams, tparams, batch, 6, 1e-3, **kw)
    _check_metrics(tm, jm)
    _close(tq, jq)
