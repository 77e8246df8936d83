"""The port's pytree engine (the reference's default `pack_params=False`
path) held against the JAX reference on the reduced dense LM, on the CPU.

Both packages run `Federation.make_step(loss_fn, privatizer=...)` with the
default pytree state, then `run_rounds` and `reconcile`, from the same
weights, batches and keys, in three forms: the jnp-equivalent privatizer
(fused_kernel=False, `random.laplace` per leaf), the fused privatizer (the
`sqnorm` and `scale_noise` kernels' plain versions here; the reference's
jnp oracles), and the tree mechanism at depth 2 with fused_kernel=False.
Owner sequences, refused masks, the reconciled ledger (with its tree view)
and the leaf counts match exactly; theta_L, every bank leaf and every node
leaf agree within rtol 1e-4 and atol 1e-6, the tolerance of the flat
engine's parity tests (two autodiff systems; log1p may differ by an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federation as jfed
import repro_torch.federation as tfed
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build_model
from repro_torch import random as trandom
from repro_torch.configs.base import DENSE_124M
from repro_torch.convert import params_from_numpy
from repro_torch.federation import ParamFlat
from repro_torch.models import LM
from repro_torch.tree_util import tree_flatten

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-6
N_LM, K_LM = 4, 10

JAX_REDUCED = JaxModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab=50304).reduced()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_case():
    jlm = jax_build_model(JAX_REDUCED, remat=False)
    jparams = jlm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, JAX_REDUCED.vocab, size=(K_LM, 4, 16),
                                             dtype=np.int32)
    return jlm, jparams, {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}


def _ledger_parity(led_torch, led_jax):
    """The port's ledger equals the reference's on every key it has; the
    reference's fault and staleness columns are all zero here."""
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


FORMS = {
    # form: (fused_kernel, mechanism kwargs, horizon); horizon 3 (paper) and
    # capacity 3 (tree) over 10 rounds of 4 owners make refusals bite
    "unfused": (False, {}, 3),
    "fused": (True, {}, 3),
    "tree": (False, dict(mechanism="tree", tree_depth=2), 8),
}


def _sessions(lm_case, form):
    jlm, jparams, _ = lm_case
    fused, mech, horizon = FORMS[form]
    lm = LM(DENSE_124M.reduced())
    out = []
    for mod, loss, kw in ((jfed, lambda p, b: jlm.loss(p, b)[0], {}),
                          (tfed, lambda p, b: lm.loss(p, b)[0], dict(device=CPU))):
        owners = [mod.DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0) for i in range(N_LM)]
        fed = mod.Federation(owners, mod.FederationConfig.from_target_lr(
            0.05, n_owners=N_LM, horizon=horizon, sigma=1e-2, theta_max=100.0), **mech, **kw)
        fed.make_step(loss, privatizer=mod.PrivatizerConfig(
            xi=1.0, granularity="microbatch", n_microbatches=2, fused_kernel=fused))
        params = (jparams if mod is jfed else
                  params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU))
        out.append((fed, fed.init_state(params)))
    return out


@pytest.mark.parametrize("form", sorted(FORMS))
def test_reduced_lm_pytree_session_matches_reference(lm_case, form):
    _, _, data = lm_case
    (jf, js), (tf, ts) = _sessions(lm_case, form)
    assert not isinstance(ts.theta_L, ParamFlat)            # the default is the pytree
    js, jm = jf.run_rounds(js, {n: jnp.asarray(v) for n, v in data.items()},
                           key=jax.random.PRNGKey(5))
    ts, tm = tf.run_rounds(ts, {n: torch.from_numpy(v) for n, v in data.items()},
                           key=trandom.PRNGKey(5, device=CPU))
    np.testing.assert_array_equal(tm["owner"].numpy(), np.asarray(jm["owner"]))
    refused = tm["refused"].numpy()
    np.testing.assert_array_equal(refused, np.asarray(jm["refused"]))
    assert refused.any() and not refused.all()              # refusal really bites
    _ledger_parity(tf.reconcile(ts), jf.reconcile(js))
    assert int(ts.step) == int(js.step) == int((~refused).sum())
    np.testing.assert_array_equal(ts.ledger.spent.numpy(), np.asarray(js.ledger.spent))
    for name in ("clip_frac", "max_grad_norm", "grad_noise_scale"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]), rtol=1e-5)
    _assert_trees_close(ts.theta_L, js.theta_L)
    _assert_trees_close(ts.bank, js.bank)
    _assert_trees_close(tf.params_of(ts), jf.params_of(js))
    if form == "tree":
        np.testing.assert_array_equal(ts.tree.counts.numpy(), np.asarray(js.tree.counts))
        _assert_trees_close(ts.tree.nodes, js.tree.nodes)
        assert all(bool(leaf.ne(0).any()) for leaf in tree_flatten(ts.tree.nodes)[0])
