"""The port's hybrid LM (zamba2: Mamba2 layers and one shared attention
block) against the reference on the reduced zamba2-2.7b (2 layers, d 256,
attn_every 2, ssm d_state 16, head dim 32, chunk 32), weights converted
from the reference's init, tokens from a numpy seed.

Tolerances: final hiddens within 5e-5 (f32 through two Mamba2 layers and
the shared block, other summation orders; the hiddens reach about 4) and
the loss within 1e-5; logits within 1e-5 per decode step (they are about
0.3). Inside the port, decode equals the forward within 5e-3, the bound
of the reference's own test (tests/test_arch_smoke.py), and the serve
loop's tokens equal the reference's exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.launch.serve import greedy_decode, main as serve_main
from repro_torch.launch.steps import prefill_logits
from repro_torch.models import LM, build_model
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import Mamba2Params, Mamba2State

ARCH = "zamba2-2.7b"
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


def _tokens(S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(B, S), dtype=np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_reduced_config_and_sizes_match_reference(case):
    jlm, jparams, params = case
    cfg = get_config(ARCH).reduced()
    jcfg = jax_get_config(ARCH).reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "head_dim",
              "attn_every", "sliding_window", "long_context_override", "rope_theta"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for f in ("d_state", "d_conv", "expand", "head_dim", "chunk"):
        assert getattr(cfg.ssm, f) == getattr(jcfg.ssm, f), f
    assert cfg.ssm.d_state == 16 and cfg.ssm.head_dim == 32 and cfg.ssm.chunk == 32
    n_ref = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    assert cfg.param_count() == n_ref
    assert get_config(ARCH).param_count() == 2_343_741_088
    assert isinstance(params["blocks"]["mamba"], Mamba2Params)
    # the port's own init: the reference's leaf names and shapes
    mine = LM(cfg).init(seed=0, device=CPU)
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(jparams))
    tshapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), mine)
    assert sorted(mine) == sorted(jparams)
    assert tshapes["blocks"]["ln"] == jshapes["blocks"]["ln"]
    assert tshapes["blocks"]["mamba"]._asdict() == jshapes["blocks"]["mamba"]._asdict()
    assert tshapes["shared_attn"]._asdict() == jshapes["shared_attn"]._asdict()
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(mine)) == cfg.param_count()


def test_registry():
    """Every arch of the reference resolves (tests/test_torch_zoo.py holds
    them field for field); an unknown one raises."""
    assert list_archs() == ["command-r-35b", "granite-20b", "internvl2-2b", "mixtral-8x22b",
                            "qwen1.5-110b", "qwen3-moe-30b-a3b", "whisper-medium", "xlstm-125m",
                            "yi-6b", "zamba2-2.7b"]
    assert get_config("internvl2-2b").family == "vlm"
    assert get_config("whisper-medium").family == "audio"
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-17")


@pytest.mark.parametrize("S", [64, 80])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_forward_matches_reference(case, S, backend):
    jlm, jparams, params = case
    toks = _tokens(S, seed=S)
    want, _ = jlm.forward(jparams, {"tokens": jnp.asarray(toks)})
    got = build_model(get_config(ARCH).reduced(), attn_backend=backend).forward(
        params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("S", [64, 80])
def test_loss_and_prefill_logits_match_reference(case, S):
    jlm, jparams, params = case
    toks = _tokens(S, seed=S + 1)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want = float(jlm.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})[0])
    lm = LM(get_config(ARCH).reduced(), attn_backend="pallas")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert float(lm.loss(params, tb)[0]) == pytest.approx(want, abs=1e-5)
    # the reference's prefill step body: the last position's logits
    x, _ = jlm.forward(jparams, {"tokens": jnp.asarray(toks)})
    want_logits = np.asarray(jnp.einsum("bd,dv->bv", x[:, -1], jlm._unembed(jparams)))
    np.testing.assert_allclose(prefill_logits(lm, params, tb).numpy(), want_logits, atol=1e-5)


def test_init_cache_matches_reference(case):
    jlm, _, _ = case
    lm = LM(get_config(ARCH).reduced())
    for window in (None, 8):
        want = _np(jlm.init_cache(B, 20, window=window, dtype=jnp.float32))
        got = lm.init_cache(B, 20, window=window, dtype=torch.float32, device=CPU)
        assert sorted(got) == sorted(want) == ["mamba", "shared"]
        assert len(got["mamba"]) == len(want["mamba"]) == 2
        assert len(got["shared"]) == len(want["shared"]) == 1
        for g, w in zip(got["mamba"] + got["shared"], want["mamba"] + want["shared"]):
            assert type(g).__name__ == type(w).__name__
            for gt, wt in zip(g, w):
                assert tuple(gt.shape) == wt.shape and not gt.any()
        assert isinstance(got["mamba"][0], Mamba2State) and isinstance(got["shared"][0], KVCache)
    assert lm.init_cache(B, 20, device=CPU)["mamba"][0].conv.dtype == torch.bfloat16
    # the reference's default bf16 cache carries across by its bits
    jcache = jlm.init_cache(B, 20)
    jcache["mamba"][0] = jcache["mamba"][0]._replace(
        conv=jnp.linspace(-3, 3, jcache["mamba"][0].conv.size, dtype=jnp.bfloat16).reshape(
            jcache["mamba"][0].conv.shape))
    got = cache_from_numpy(_np(jcache), device=CPU)
    assert got["shared"][0].k.dtype == torch.bfloat16
    np.testing.assert_array_equal(got["mamba"][0].conv.float().numpy(),
                                  np.asarray(jcache["mamba"][0].conv, np.float32))


def _decode_both(jlm, jparams, lm, params, toks, jcache, cache, start, window=None):
    """Decode toks[:, start:] in both packages; returns the largest logit
    difference and the caches."""
    err = 0.0
    for t in range(start, toks.shape[1]):
        jl, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                                     jnp.int32(t), window=window)
        tl, cache = lm.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]), t,
                                   window=window)
        assert tuple(tl.shape) == (B, 1, lm.cfg.vocab)
        err = max(err, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    return err, jcache, cache


def test_decode_matches_reference(case):
    jlm, jparams, params = case
    lm = LM(get_config(ARCH).reduced())
    toks = _tokens(12, seed=3)
    err, _, _ = _decode_both(jlm, jparams, lm, params, toks,
                             jlm.init_cache(B, 12, dtype=jnp.float32),
                             lm.init_cache(B, 12, dtype=torch.float32, device=CPU), 0)
    assert err < 1e-5, err


def test_decode_from_a_reference_cache(case):
    """The reference decodes 6 tokens; its cache, carried across with
    cache_from_numpy, lets the port decode the next 6 as the reference
    does."""
    jlm, jparams, params = case
    lm = LM(get_config(ARCH).reduced())
    toks = _tokens(12, seed=4)
    jcache = jlm.init_cache(B, 12, dtype=jnp.float32)
    for t in range(6):
        _, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
    cache = cache_from_numpy(_np(jcache), device=CPU)
    assert isinstance(cache["shared"][0], KVCache) and isinstance(cache["mamba"][1], Mamba2State)
    err, _, _ = _decode_both(jlm, jparams, lm, params, toks, jcache, cache, 6)
    assert err < 1e-5, err


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_decode_matches_forward_inside_the_port(case, backend):
    _, _, params = case
    lm = LM(get_config(ARCH).reduced(), attn_backend=backend)
    toks = torch.from_numpy(_tokens(40, seed=5))               # a chunk of 32 and a ragged one
    full = torch.einsum("bsd,dv->bsv", lm.forward(params, {"tokens": toks}), lm._unembed(params))
    cache = lm.init_cache(B, 40, dtype=torch.float32, device=CPU)
    err = 0.0
    for t in range(40):
        lg, cache = lm.decode_step(params, cache, toks[:, t:t + 1], t)
        err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
    assert err < 5e-3, err


def test_greedy_decode_matches_the_reference_loop(case):
    """greedy_decode against the reference's serve loop (serve.py:54-63)
    written out with the reference's decode_step: every step's logits
    within 1e-5, the tokens equal."""
    jlm, jparams, params = case
    lm = LM(get_config(ARCH).reduced())
    plen, gen = 5, 7
    prompt = _tokens(plen, seed=6)
    total = plen + gen
    jcache = jlm.init_cache(B, total, dtype=jnp.float32)
    toks = jnp.asarray(prompt[:, :1])
    out, logits = [toks], []
    for t in range(total - 1):
        lg, jcache = jlm.decode_step(jparams, jcache, toks, jnp.int32(t))
        logits.append(np.asarray(lg[:, -1]))
        if t + 1 < plen:
            toks = jnp.asarray(prompt[:, t + 1:t + 2])
        else:
            toks = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        out.append(toks)
    want_tokens = np.asarray(jnp.concatenate(out, axis=1))
    seqs, got_logits = greedy_decode(lm, params,
                                     lm.init_cache(B, total, dtype=torch.float32, device=CPU),
                                     torch.from_numpy(prompt), gen)
    assert tuple(got_logits.shape) == (B, total - 1, 512)
    np.testing.assert_allclose(got_logits.numpy(), np.stack(logits, axis=1), atol=1e-5)
    np.testing.assert_array_equal(seqs.numpy(), want_tokens)


def test_serve_main_runs_on_the_cpu(capsys):
    seqs = serve_main(["--arch", ARCH, "--batch", "2", "--prompt-len", "3", "--gen", "4",
                       "--device", "cpu"])
    assert seqs.shape == (2, 7)
    assert "zamba2-2.7b-smoke" in capsys.readouterr().out


def test_unported_families_and_bad_settings_raise():
    import dataclasses
    cfg = get_config(ARCH).reduced()
    with pytest.raises(ValueError, match="unknown family"):
        LM(dataclasses.replace(cfg, family="rnn"))
    with pytest.raises(ValueError, match="backend"):
        LM(cfg, attn_backend="flash")
    with pytest.raises(ValueError, match="attn_every"):
        LM(dataclasses.replace(cfg, n_layers=3))


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


def test_loss_gradient_matches_reference(case, scan_route):
    """The reduced zamba2's loss gradient (S 40: a chunk of 32 and a ragged
    one) against jax.grad of the reference's loss: every leaf within 1e-4
    of its largest |gradient| (f32 through two Mamba2 layers and the shared
    block, other summation orders in the two autodiff systems)."""
    from repro_torch.tree_util import tree_flatten, tree_unflatten
    jlm, jparams, params = case
    toks = _tokens(40, seed=9)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jgrads = jax.grad(lambda p: jlm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(
        jparams)
    lm = LM(get_config(ARCH).reduced(), remat=False)      # as `case`'s reference model
    leaves, treedef = tree_flatten(params)
    live = [x.detach().clone().requires_grad_(True) for x in leaves]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = lm.loss(tree_unflatten(treedef, live), tbatch)[0]
    grads = torch.autograd.grad(loss, live)
    assert scan_route is None or len(scan_route) == lm.cfg.n_layers
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        want = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()) + 1e-12)


def test_federated_rounds_match_reference(case, scan_route):
    """A few rounds of the flat fused engine over the reduced hybrid in both
    packages, same weights, batches, owners and keys (horizon 2, so
    refusals bite): owner sequences, refusals and the reconciled ledger
    exactly; theta_L and the bank within rtol 1e-4, atol 1e-6 (the
    tolerance of tests/test_torch_federation.py: two autodiff systems sum
    in other orders, and the Laplace transform's log1p may differ by an
    ulp)."""
    import repro.federation as jfed
    import repro_torch.federation as tfed
    from repro_torch import random as trandom
    jlm, jparams, params = case
    n_owners, K, G = 3, 5, 2
    toks = np.random.default_rng(12).integers(0, 512, size=(K, 4, 40), dtype=np.int32)
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
    lm = LM(get_config(ARCH).reduced(), remat=False)      # as `case`'s reference model
    tf, tpriv = setup(tfed, device=CPU)
    tf.make_step(lambda p, b: lm.loss(p, b)[0], privatizer=tpriv, pack_params=True)
    ts, tm = tf.run_rounds(tf.init_state(params), {k: torch.from_numpy(v) for k, v in data.items()},
                           key=trandom.PRNGKey(3, device=CPU))
    tf.reconcile(ts)
    assert scan_route is None or len(scan_route) == K * G * lm.cfg.n_layers
    np.testing.assert_array_equal(tm["owner"].numpy(), np.asarray(jm["owner"]))
    np.testing.assert_array_equal(tm["refused"].numpy(), np.asarray(jm["refused"]))
    assert tm["refused"].any()
    jled = jf.ledger()
    for i, row in tf.ledger().items():
        assert row == {k: jled[i][k] for k in row}, i
    np.testing.assert_allclose(ts.theta_L.buf.numpy(), np.asarray(js.theta_L.buf), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ts.bank.numpy(), np.asarray(js.bank), rtol=1e-4, atol=1e-6)
