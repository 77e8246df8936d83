"""The port's synchronous deep baseline (deep.make_sync_dp_step and
Federation(strategy="sync").make_step/sync_round) against the reference,
on the CPU.

Both packages run the same params, per-owner batches and keys on a toy MLP
and on the reduced dense LM, with the jnp-equivalent privatizer and with
fused_kernel=True (the reference runs its kernels' jnp oracles, the port
its plain versions), in both granularities. Tolerance rtol 1e-4, atol 1e-6
on the params: the gradients come from two autodiff systems and the clip
norms sum in other orders (as in test_torch_dp_sgd.py). Exact: the ledger,
which owners are live, and the fully refused round, which returns the
params untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federation as J
import repro_torch.federation as T
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro_torch import random as trandom
from repro_torch.configs.base import DENSE_124M
from repro_torch.convert import params_from_numpy
from repro_torch.models import LM
from repro_torch.tree_util import tree_flatten

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-6
N = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp_params():
    rng = np.random.default_rng(0)
    return {"w1": rng.standard_normal((5, 8)).astype(np.float32) * 0.7,
            "b1": rng.standard_normal(8).astype(np.float32) * 0.1,
            "w2": rng.standard_normal(8).astype(np.float32),
            "b2": np.float32(0.3)}


def _mlp_batches(B=4):
    rng = np.random.default_rng(1)
    return {"x": rng.standard_normal((N, B, 5)).astype(np.float32),
            "y": rng.standard_normal((N, B)).astype(np.float32)}


def _jax_mlp_loss(p, b):
    h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] + p["b2"] - b["y"]) ** 2)


def _torch_mlp_loss(p, b):
    h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] + p["b2"] - b["y"]) ** 2)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(t_tree, j_tree):
    t_leaves, j_leaves = tree_flatten(t_tree)[0], jax.tree_util.tree_leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def _owners(mod, sizes=(100, 300, 200), eps=(1.0, 2.0, 4.0)):
    return [mod.DataOwner(n=n, epsilon=e, xi=1.0) for n, e in zip(sizes, eps)]


def _pair(horizon=5, mechanism="paper", theta_max=10.0, **priv):
    cfg = dict(horizon=horizon, sigma=1e-2, theta_max=theta_max)
    jf = J.Federation(_owners(J), J.FederationConfig(**cfg), strategy="sync",
                      mechanism=mechanism)
    tf = T.Federation(_owners(T), T.FederationConfig(**cfg), strategy="sync",
                      mechanism=mechanism, device=CPU)
    return jf, tf, J.PrivatizerConfig(**priv), T.PrivatizerConfig(**priv)


PRIVATIZERS = [dict(xi=0.5, granularity="example"),
               dict(xi=0.5, granularity="microbatch", n_microbatches=2),
               dict(xi=0.5, granularity="microbatch", n_microbatches=2, fused_kernel=True),
               dict(xi=100.0, granularity="microbatch", n_microbatches=4, fused_kernel=True)]


@pytest.mark.parametrize("priv", PRIVATIZERS)
@pytest.mark.parametrize("weights", [None, (1.0, 0.0, 1.0)])
def test_sync_step_matches_the_reference(priv, weights):
    jf, tf, jp, tp = _pair(**priv)
    jstep = jf.make_step(_jax_mlp_loss, privatizer=jp, lr=0.05)
    tstep = tf.make_step(_torch_mlp_loss, privatizer=tp, lr=0.05)
    params, batches = _mlp_params(), _mlp_batches()
    jw = None if weights is None else jnp.asarray(weights, jnp.float32)
    tw = None if weights is None else torch.tensor(weights)
    ref = jstep(jax.tree_util.tree_map(jnp.asarray, params),
                jax.tree_util.tree_map(jnp.asarray, batches), jax.random.PRNGKey(3), jw)
    ours = tstep(_to_torch(params), _to_torch(batches), trandom.PRNGKey(3, device=CPU), tw)
    _close(ours, ref)


def test_zero_weight_owner_drops_out():
    # owner 1 weighted 0 gives the same params as a step whose owner 1 has
    # an all-zero gradient and no noise: its response does not enter
    _, tf, _, tp = _pair(xi=0.5, granularity="example")
    tstep = tf.make_step(_torch_mlp_loss, privatizer=tp, lr=0.05)
    params, batches = _to_torch(_mlp_params()), _to_torch(_mlp_batches())
    key = trandom.PRNGKey(4, device=CPU)
    w = torch.tensor([1.0, 0.0, 1.0])
    a = tstep(params, batches, key, w)
    other = dict(batches, y=batches["y"].clone())
    other["y"][1] += 5.0                                  # owner 1's data changes
    b = tstep(params, other, key, w)
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        assert torch.equal(x, y)
    c = tstep(params, other, key, torch.ones(3))
    assert not all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[0], tree_flatten(c)[0]))


def test_make_sync_dp_step_matches_the_reference_with_its_own_scales():
    kw = dict(n_owners=N, horizon=7, sigma=1e-2, epsilons=(1.0, 2.0, 4.0),
              owner_sizes=(100, 300, 200), xi=0.5, theta_max=0.2)
    jcfg = J.AsyncDPConfig(privatizer=J.PrivatizerConfig(xi=0.5, n_microbatches=2), **kw)
    tcfg = T.AsyncDPConfig(privatizer=T.PrivatizerConfig(xi=0.5, n_microbatches=2), **kw)
    jstep = J.make_sync_dp_step(_jax_mlp_loss, jcfg, 0.5)
    tstep = T.make_sync_dp_step(_torch_mlp_loss, tcfg, 0.5, device=CPU)
    params, batches = _mlp_params(), _mlp_batches()
    ref = jstep(jax.tree_util.tree_map(jnp.asarray, params),
                jax.tree_util.tree_map(jnp.asarray, batches), jax.random.PRNGKey(5))
    ours = tstep(_to_torch(params), _to_torch(batches), trandom.PRNGKey(5, device=CPU))
    _close(ours, ref)
    assert max(float(leaf.abs().max()) for leaf in tree_flatten(ours)[0]) <= np.float32(0.2)
    with pytest.raises(ValueError, match="tree mechanism"):
        T.make_sync_dp_step(_torch_mlp_loss, T.AsyncDPConfig(tree_depth=2, **kw), 0.5,
                            device=CPU)


def _ledger_parity(led_torch, led_jax):
    assert set(led_torch) == set(led_jax)
    for i, row in led_torch.items():
        jrow = led_jax[i]
        assert row == {k: jrow[k] for k in row}, i
        assert all(jrow[k] == 0 for k in set(jrow) - set(row)), i


def test_sync_rounds_ledger_and_the_fully_refused_no_op():
    jf, tf, jp, tp = _pair(horizon=2, xi=0.5, granularity="microbatch", n_microbatches=2,
                           fused_kernel=True)
    jf.make_step(_jax_mlp_loss, privatizer=jp, lr=0.05)
    tf.make_step(_torch_mlp_loss, privatizer=tp, lr=0.05)
    jparams = jax.tree_util.tree_map(jnp.asarray, _mlp_params())
    tparams = _to_torch(_mlp_params())
    jb = jax.tree_util.tree_map(jnp.asarray, _mlp_batches())
    tb = _to_torch(_mlp_batches())
    for r in range(2):
        jparams = jf.sync_round(jparams, jb, jax.random.PRNGKey(10 + r))
        tparams = tf.sync_round(tparams, tb, trandom.PRNGKey(10 + r, device=CPU))
        _close(tparams, jparams)
        _ledger_parity(tf.ledger(), jf.ledger())
    # every owner is exhausted: the round returns its input untouched
    assert tf.sync_round(tparams, tb, trandom.PRNGKey(12, device=CPU)) is tparams
    jf.sync_round(jparams, jb, jax.random.PRNGKey(12))
    _ledger_parity(tf.ledger(), jf.ledger())
    assert all(r["responses"] == 2 and r["refused"] == 1 for r in tf.ledger().values())


def test_strict_mechanism_reads_n_params():
    jf, tf, jp, tp = _pair(mechanism="strict", xi=0.5, granularity="example")
    with pytest.raises(ValueError, match="dimension p"):
        tf.make_step(_torch_mlp_loss, privatizer=tp, lr=0.05)
    n_params = 5 * 8 + 8 + 8 + 1
    jstep = jf.make_step(_jax_mlp_loss, privatizer=jp, lr=0.05, n_params=n_params)
    tstep = tf.make_step(_torch_mlp_loss, privatizer=tp, lr=0.05, n_params=n_params)
    params, batches = _mlp_params(), _mlp_batches()
    ref = jstep(jax.tree_util.tree_map(jnp.asarray, params),
                jax.tree_util.tree_map(jnp.asarray, batches), jax.random.PRNGKey(6))
    ours = tstep(_to_torch(params), _to_torch(batches), trandom.PRNGKey(6, device=CPU))
    _close(ours, ref)


def test_the_sync_session_raises_where_the_reference_raises():
    _, tf, _, tp = _pair(xi=0.5, granularity="example")
    with pytest.raises(ValueError, match="explicit lr"):
        tf.make_step(_torch_mlp_loss, privatizer=tp)
    with pytest.raises(RuntimeError, match="make_step"):
        tf.sync_round(_to_torch(_mlp_params()), _to_torch(_mlp_batches()),
                      trandom.PRNGKey(0, device=CPU))
    tf.make_step(_torch_mlp_loss, privatizer=tp, lr=0.05)
    key = trandom.PRNGKey(0, device=CPU)
    with pytest.raises(ValueError, match="async path"):
        tf.step(None, {}, 0, key)
    with pytest.raises(ValueError, match="async path"):
        tf.run_rounds(None, {}, [0], key=key)
    tree = T.Federation(_owners(T), T.FederationConfig(horizon=5), strategy="sync",
                        mechanism="tree", tree_depth=2, device=CPU)
    with pytest.raises(ValueError, match="tree mechanism"):
        tree.make_step(_torch_mlp_loss, privatizer=tp, lr=0.05)
    asyn = T.Federation(_owners(T), T.FederationConfig(horizon=5), device=CPU)
    with pytest.raises(ValueError, match="strategy='sync'"):
        asyn.sync_round(None, {}, key)


# ------------------------------ the reduced dense LM ------------------------------
JAX_REDUCED = JaxModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab=50304).reduced()


@pytest.mark.parametrize("fused", [False, True])
def test_sync_round_on_the_reduced_lm_matches_the_reference(fused):
    jlm = jax_build_model(JAX_REDUCED, remat=False)
    jparams = jlm.init(jax.random.PRNGKey(1))
    lm = LM(DENSE_124M.reduced())
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    toks = np.random.default_rng(2).integers(0, JAX_REDUCED.vocab, size=(N, 4, 16),
                                             dtype=np.int32)
    batches = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    jf, tf, jp, tp = _pair(theta_max=100.0, xi=1.0, granularity="microbatch",
                           n_microbatches=2, fused_kernel=fused)
    jf.make_step(lambda p, b: jlm.loss(p, b)[0], privatizer=jp, lr=0.05)
    tf.make_step(lambda p, b: lm.loss(p, b)[0], privatizer=tp, lr=0.05)
    ref = jf.sync_round(jparams, jax.tree_util.tree_map(jnp.asarray, batches),
                        jax.random.PRNGKey(7))
    ours = tf.sync_round(tparams, {k: torch.from_numpy(v) for k, v in batches.items()},
                         trandom.PRNGKey(7, device=CPU))
    _close(ours, ref)
    _ledger_parity(tf.ledger(), jf.ledger())
