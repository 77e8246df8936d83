"""The port's pytree engine against the reference from where a user starts:
with NO privatizer given, and from a state carried across mid-run, on the
reduced dense LM on the CPU.

A session built with no privatizer computes what the reference's does:
both default to `PrivatizerConfig(xi=xi)` (8 microbatches, the
jnp-equivalent Laplace draw per leaf) and to the state make_step chose,
pytree or flat. A mid-run pytree state (theta_L, the bank, the noise trees
and their counts, under the tree at depth 3) carried into the port by
`convert.pytree_state_from_numpy` runs on as the reference's does.
Owners, refusals, ledgers and counts exact; theta_L, the bank and the
nodes within rtol 1e-4 and atol 1e-6, as in test_torch_pytree_session.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federation as jfed
import repro_torch.federation as tfed
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.federation import deep as jdeep
from repro.models import build_model as jax_build_model
from repro_torch import random as trandom
from repro_torch.configs.base import DENSE_124M
from repro_torch.convert import params_from_numpy, pytree_state_from_numpy, tree_noise_from_numpy
from repro_torch.federation import ParamFlat
from repro_torch.models import LM
from repro_torch.tree_util import tree_flatten, tree_map

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-6

JAX_REDUCED = JaxModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab=50304).reduced()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ledger_parity(led_torch, led_jax):
    assert set(led_torch) == set(led_jax)
    for i, row in led_torch.items():
        jrow = led_jax[i]
        assert row == {k: jrow[k] for k in row}, i
        assert all(jrow[k] == 0 for k in set(jrow) - set(row)), i


def _assert_trees_close(t_tree, j_tree):
    t_leaves = tree_flatten(t_tree)[0]
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    assert len(t_leaves) == len(j_leaves) > 0
    for t, j in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def lm_case():
    jlm = jax_build_model(JAX_REDUCED, remat=False)
    jparams = jlm.init(jax.random.PRNGKey(2))
    return jlm, jparams


def _lm_feds(lm_case, horizon, **fed_kw):
    jlm, jparams = lm_case
    lm = LM(DENSE_124M.reduced())
    out = []
    for mod, loss, kw in ((jfed, lambda p, b: jlm.loss(p, b)[0], {}),
                          (tfed, lambda p, b: lm.loss(p, b)[0], dict(device=CPU))):
        owners = [mod.DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0) for i in range(3)]
        fed = mod.Federation(owners, mod.FederationConfig.from_target_lr(
            0.05, n_owners=3, horizon=horizon, sigma=1e-2, theta_max=100.0), **fed_kw, **kw)
        params = (jparams if mod is jfed else
                  params_from_numpy(_np_tree(jparams), device=CPU))
        out.append((fed, loss, params))
    return out


@pytest.mark.parametrize("pack_params", [False, True])
def test_default_privatizer_matches_reference(lm_case, pack_params):
    # no privatizer: both take PrivatizerConfig(xi=1.0) -- 8 microbatches,
    # the jnp-equivalent Laplace draw per leaf -- on the state make_step chose
    rng = np.random.default_rng(3)
    toks = rng.integers(0, JAX_REDUCED.vocab, size=(4, 8, 8), dtype=np.int32)
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    (jf, jloss, jparams), (tf, tloss, tparams) = _lm_feds(lm_case, horizon=50)
    assert tf.as_async_config().privatizer == tfed.PrivatizerConfig(xi=1.0)
    assert tf.as_async_config().privatizer.fused_kernel is False
    assert tfed.AsyncDPConfig(n_owners=1, horizon=1).privatizer == tfed.PrivatizerConfig(xi=1.0)
    jf.make_step(jloss, pack_params=pack_params)
    tf.make_step(tloss, pack_params=pack_params)
    js, ts = jf.init_state(jparams), tf.init_state(tparams)
    assert isinstance(ts.theta_L, ParamFlat) == pack_params
    js, jm = jf.run_rounds(js, {n: jnp.asarray(v) for n, v in data.items()}, [0, 2, 2, 1],
                           key=jax.random.PRNGKey(4))
    ts, tm = tf.run_rounds(ts, {n: torch.from_numpy(v) for n, v in data.items()}, [0, 2, 2, 1],
                           key=trandom.PRNGKey(4, device=CPU))
    _ledger_parity(tf.reconcile(ts), jf.reconcile(js))
    if pack_params:
        np.testing.assert_allclose(ts.theta_L.buf.numpy(), np.asarray(js.theta_L.buf),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ts.bank.numpy(), np.asarray(js.bank), rtol=RTOL, atol=ATOL)
    else:
        _assert_trees_close(ts.theta_L, js.theta_L)
        _assert_trees_close(ts.bank, js.bank)


def test_reduced_lm_from_a_mid_run_pytree_state(lm_case):
    # depth 3 (capacity 7) started mid-run: counts 3, 5, 6 put the next
    # leaves at retire patterns r = 2, 1, 0; owner 2 reaches its cap
    counts = np.array([3, 5, 6], np.int32)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, JAX_REDUCED.vocab, size=(8, 4, 16), dtype=np.int32)
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    (jf, jloss, jparams), (tf, tloss, _) = _lm_feds(lm_case, horizon=8, mechanism="tree",
                                                     tree_depth=3)
    priv = dict(xi=1.0, n_microbatches=2)
    jf.make_step(jloss, privatizer=jfed.PrivatizerConfig(**priv))
    tf.make_step(tloss, privatizer=tfed.PrivatizerConfig(**priv))
    for fed in (jf, tf):
        for i, c in enumerate(counts):
            assert fed.mechanism.authorize_many(i, int(c)) == c
    # a mid-run state: theta_L moved, every owner's copy its own, active nodes
    theta = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.01 * rng.standard_normal(a.shape)).astype(np.float32),
        jparams)
    bank = jax.tree_util.tree_map(
        lambda a: (a[None] + 0.01 * rng.standard_normal((3,) + a.shape)).astype(np.float32),
        theta)
    active = (counts[:, None] >> np.arange(3)[None, :]) & 1
    nodes = jax.tree_util.tree_map(
        lambda a: (0.05 * rng.standard_normal((3, 3) + a.shape)
                   * active.reshape((3, 3) + (1,) * a.ndim)).astype(np.float32), theta)
    js = jf.init_state(jparams)
    js = js._replace(theta_L=jax.tree_util.tree_map(jnp.asarray, theta),
                     bank=jax.tree_util.tree_map(jnp.asarray, bank), step=jnp.int32(14),
                     tree=jdeep.TreeNoise(jax.tree_util.tree_map(jnp.asarray, nodes),
                                          jnp.asarray(counts), 3))
    ledger = tf.init_state(params_from_numpy(theta, device=CPU)).ledger
    ts = pytree_state_from_numpy(theta, bank, 14,
                                 tree=tree_noise_from_numpy(nodes, counts, 3, device=CPU),
                                 ledger=ledger, device=CPU)
    assert tree_map(lambda a: a.shape, ts.tree.nodes) == tree_map(lambda a: a.shape, nodes)
    js, jm = jf.run_rounds(js, {n: jnp.asarray(v) for n, v in data.items()},
                           key=jax.random.PRNGKey(8))
    ts, tm = tf.run_rounds(ts, {n: torch.from_numpy(v) for n, v in data.items()},
                           key=trandom.PRNGKey(8, device=CPU))
    np.testing.assert_array_equal(tm["owner"].numpy(), np.asarray(jm["owner"]))
    np.testing.assert_array_equal(tm["refused"].numpy(), np.asarray(jm["refused"]))
    assert bool(tm["refused"].any())
    _ledger_parity(tf.reconcile(ts), jf.reconcile(js))
    assert int(ts.step) == int(js.step)
    np.testing.assert_array_equal(ts.tree.counts.numpy(), np.asarray(js.tree.counts))
    _assert_trees_close(ts.theta_L, js.theta_L)
    _assert_trees_close(ts.bank, js.bank)
    _assert_trees_close(ts.tree.nodes, js.tree.nodes)
