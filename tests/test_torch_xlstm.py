"""The port's xLSTM (the ssm family: mLSTM blocks through the SSD scan, the
sLSTM's sequential cell) against the reference on the reduced xlstm-125m
(2 layers, d 256, 4 heads: the mLSTM's head N = 128, P = N + 1 = 129; the
sLSTM at layer 1), weights converted from the reference's init, tokens
and inputs from a numpy seed.

Tolerances (those of tests/test_torch_hybrid.py): block outputs and final
hiddens within 5e-5, the loss within 1e-5, logits within 1e-5 per decode
step, decode states within 5e-5 of their largest value, gradients within
1e-4 of each leaf's largest |gradient|, and federated rounds' theta_L and
bank within rtol 1e-4, atol 1e-6, with owner sequences, refusals and the
ledger exact. Inside the port, decode equals the forward within 5e-3 (the
reference test's bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import xlstm as jx
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import LM
from repro_torch.models import xlstm as tx

ARCH = "xlstm-125m"
CPU = "cpu"
B = 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    jcfg = jax_get_config(ARCH).reduced()
    jlm = jax_build_model(jcfg, remat=False)
    jparams = jlm.init(jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    return jlm, jparams, params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(B, S), dtype=np.int32)


def _x(S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, 256)).astype(np.float32)


def _close_rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()) + 1e-12)


def _through_the_op(v, ld, k, q, g, *, chunk, h0=None):
    """ops.ssd_chunked's CUDA route on CPU tensors: the intra-chunk part
    through the SSDChunkScan op (its plain bodies here), then
    combine_chunks, so that autograd runs the op's backward."""
    from repro_torch.kernels.ssm_scan import ops
    Q = min(chunk, v.shape[1])
    parts = ops.SSDChunkScan.apply(v, ld.to(torch.float32), k, q, g.to(torch.float32), Q)
    y, h = ops.combine_chunks(*parts, q, Q, h0)
    return y.to(v.dtype), h


@pytest.fixture(params=["plain scan", "SSDChunkScan"])
def scan_route(request, monkeypatch):
    """The port's scan on the CPU as it is (the plain whole scan: None), or
    routed as on the card through the autograd op (a list that counts the
    scans taken that way)."""
    if request.param == "plain scan":
        return None
    from repro_torch.kernels.ssm_scan import ops
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return _through_the_op(*args, **kw)

    monkeypatch.setattr(ops, "ssd_chunked", counted)
    return calls


def test_config_sizes_and_heads(case):
    _, jparams, params = case
    cfg = get_config(ARCH).reduced()
    assert cfg.xlstm.slstm_indices == (1,)
    assert tx.mlstm_dims(cfg) == (512, 4, 128)            # the mLSTM scan: N 128, P 129
    assert tx.mlstm_dims(get_config(ARCH)) == (1536, 4, 384)   # full width: N 384, P 385
    assert cfg.param_count() == sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    assert get_config(ARCH).param_count() == 199_584_812
    assert isinstance(params["blocks"][0]["mlstm"], tx.MLSTMParams)
    assert isinstance(params["blocks"][1]["slstm"], tx.SLSTMParams)
    mine = LM(cfg).init(seed=0, device=CPU)
    assert (jax.tree_util.tree_map(lambda t: tuple(t.shape), mine)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(jparams)))
    b = mine["blocks"][1]["slstm"].b
    assert torch.equal(b[..., 1], torch.full_like(b[..., 1], 3.0)) and not b[..., 0].any()
    assert torch.equal(mine["blocks"][0]["mlstm"].b_f, torch.full((4,), 3.0))


@pytest.mark.parametrize("S", [40, 300])
def test_mlstm_block_and_its_decode_match_reference(case, S, scan_route):
    """S 300: a chunk of 256 and a ragged one."""
    _, jparams, params = case
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    jp, p = jparams["blocks"][0]["mlstm"], params["blocks"][0]["mlstm"]
    x = _x(S, seed=S)
    want = np.asarray(jx.mlstm_forward(jp, jnp.asarray(x), jcfg))
    got = tx.mlstm_forward(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    assert scan_route is None or len(scan_route) == 1
    if S > 40:
        return
    jst = jx.init_mlstm_state(B, jcfg, dtype=jnp.float32)
    st = tx.init_mlstm_state(B, cfg, dtype=torch.float32, device=CPU)
    for t in range(12):
        jo, jst = jx.mlstm_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
        o, st = tx.mlstm_decode(p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=5e-5)
        np.testing.assert_allclose(o.numpy(), want[:, t:t + 1], atol=5e-5)
    for a, b in zip(st, jst):
        _close_rel(a.numpy(), b, 5e-5)


def test_slstm_block_and_its_decode_match_reference(case):
    _, jparams, params = case
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    jp, p = jparams["blocks"][1]["slstm"], params["blocks"][1]["slstm"]
    x = _x(24, seed=7)
    want = np.asarray(jx.slstm_forward(jp, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(tx.slstm_forward(p, torch.from_numpy(x), cfg).numpy(), want,
                               atol=5e-5)
    jst = jx.init_slstm_state(B, jcfg)
    st = tx.init_slstm_state(B, cfg, device=CPU)
    for t in range(24):
        jo, jst = jx.slstm_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
        o, st = tx.slstm_decode(p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=5e-5)
    for a, b in zip(st, jst):
        _close_rel(a.numpy(), b, 5e-5)


@pytest.mark.parametrize("S", [40, 300])
def test_forward_and_loss_match_reference(case, S, scan_route):
    jlm, jparams, params = case
    toks = _tokens(S, seed=S + 1)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want, jaux = jlm.forward(jparams, {"tokens": jnp.asarray(toks)})
    lm = LM(get_config(ARCH).reduced())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, aux = lm.forward_aux(params, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    assert float(aux) == float(jaux) == 0.0
    jl, jm = jlm.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, m = lm.loss(params, tb)
    assert float(loss) == pytest.approx(float(jl), abs=1e-5)
    assert float(m["ce"]) == pytest.approx(float(jm["ce"]), abs=1e-5)
    assert scan_route is None or len(scan_route) == 2 * lm.cfg.n_layers - 2


def test_loss_gradient_matches_reference(case, scan_route):
    """S 40 (one chunk); every leaf within 1e-4 of its largest |gradient|."""
    from repro_torch.tree_util import tree_flatten, tree_unflatten
    jlm, jparams, params = case
    toks = _tokens(40, seed=9)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jgrads = jax.grad(lambda p: jlm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(
        jparams)
    lm = LM(get_config(ARCH).reduced())
    leaves, treedef = tree_flatten(params)
    live = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss = lm.loss(tree_unflatten(treedef, live), {k: torch.from_numpy(v)
                                                    for k, v in batch.items()})[0]
    grads = torch.autograd.grad(loss, live)
    assert scan_route is None or len(scan_route) == 1
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        _close_rel(g.numpy(), jg, 1e-4)


def test_init_cache_and_decode_match_reference(case):
    jlm, jparams, params = case
    lm = LM(get_config(ARCH).reduced())
    want = _np(jlm.init_cache(B, 20, dtype=jnp.float32))
    got = lm.init_cache(B, 20, dtype=torch.float32, device=CPU)
    assert sorted(got) == ["states"] and len(got["states"]) == 2
    assert isinstance(got["states"][0], tx.MLSTMState)
    assert isinstance(got["states"][1], tx.SLSTMState)
    for g, w in zip(got["states"], want["states"]):
        assert type(g).__name__ == type(w).__name__
        for gt, wt in zip(g, w):
            assert tuple(gt.shape) == wt.shape and gt.dtype == torch.from_numpy(np.array(wt)).dtype
            np.testing.assert_array_equal(gt.numpy(), wt)
    assert lm.init_cache(B, 20, device=CPU)["states"][0].conv.dtype == torch.bfloat16
    toks = _tokens(12, seed=3)
    jcache = jlm.init_cache(B, 12, dtype=jnp.float32)
    cache = lm.init_cache(B, 12, dtype=torch.float32, device=CPU)
    for t in range(12):
        jl, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, cache = lm.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
        if t == 5:      # the port goes on from the reference's cache as well
            carried = cache_from_numpy(_np(jcache), device=CPU)
            assert isinstance(carried["states"][0], tx.MLSTMState)
            for a, b in zip(jax.tree_util.tree_leaves(carried), jax.tree_util.tree_leaves(cache)):
                _close_rel(a.numpy(), b.numpy(), 5e-5)


def test_decode_matches_forward_inside_the_port(case):
    _, _, params = case
    lm = LM(get_config(ARCH).reduced())
    toks = torch.from_numpy(_tokens(40, seed=5))
    full = torch.einsum("bsd,dv->bsv", lm.forward(params, {"tokens": toks}), lm._unembed(params))
    cache = lm.init_cache(B, 40, dtype=torch.float32, device=CPU)
    err = 0.0
    for t in range(40):
        lg, cache = lm.decode_step(params, cache, toks[:, t:t + 1], t)
        err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
    assert err < 5e-3, err


def test_federated_rounds_match_reference(case, scan_route):
    """Rounds of the flat fused engine over the reduced xLSTM in both
    packages, same weights, batches, owners and keys (horizon 2, so refusals
    bite): owner sequences, refusals and the reconciled ledger exactly;
    theta_L and the bank within rtol 1e-4, atol 1e-6."""
    import repro.federation as jfed
    import repro_torch.federation as tfed
    from repro_torch import random as trandom
    jlm, jparams, params = case
    n_owners, K, G = 3, 4, 2
    toks = np.random.default_rng(12).integers(0, 512, size=(K, 4, 24), dtype=np.int32)
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}

    def setup(mod, **kw):
        fed = mod.Federation([mod.DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0)
                              for i in range(n_owners)],
                             mod.FederationConfig.from_target_lr(
                                 0.05, n_owners=n_owners, horizon=2, sigma=1e-2,
                                 theta_max=100.0), **kw)
        return fed, mod.PrivatizerConfig(xi=1.0, granularity="microbatch", n_microbatches=G,
                                         fused_kernel=True)

    jf, jpriv = setup(jfed)
    jf.make_step(lambda p, b: jlm.loss(p, b)[0], privatizer=jpriv, pack_params=True)
    js, jm = jf.run_rounds(jf.init_state(jparams), {k: jnp.asarray(v) for k, v in data.items()},
                           key=jax.random.PRNGKey(3))
    jf.reconcile(js)
    lm = LM(get_config(ARCH).reduced())
    tf, tpriv = setup(tfed, device=CPU)
    tf.make_step(lambda p, b: lm.loss(p, b)[0], privatizer=tpriv, pack_params=True)
    ts, tm = tf.run_rounds(tf.init_state(params), {k: torch.from_numpy(v) for k, v in data.items()},
                           key=trandom.PRNGKey(3, device=CPU))
    tf.reconcile(ts)
    assert scan_route is None or len(scan_route) == K * G
    np.testing.assert_array_equal(tm["owner"].numpy(), np.asarray(jm["owner"]))
    np.testing.assert_array_equal(tm["refused"].numpy(), np.asarray(jm["refused"]))
    assert tm["refused"].any()
    jled = jf.ledger()
    for i, row in tf.ledger().items():
        assert row == {k: jled[i][k] for k in row}, i
    np.testing.assert_allclose(ts.theta_L.buf.numpy(), np.asarray(js.theta_L.buf), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ts.bank.numpy(), np.asarray(js.bank), rtol=1e-4, atol=1e-6)
