"""The port's vlm family (internvl2) against the reference on the reduced
internvl2-2b (2 layers, d 256, H 4, Kv 2, hd 64, d_ff 512, vocab 512, 4
patches), weights converted from the reference's init, inputs from a numpy
seed.

Tolerances: f32 within 1e-5 of the largest value (`_close`) for the final
hiddens and logits and every decode step's logits; the loss within 1e-5;
the loss gradient within 1e-4 of each leaf's largest |gradient| (two
autodiff systems sum in other orders); greedy tokens exactly. The vlm's
decode sees no patches (nor does the reference's), so inside the port it
is held within 5e-3 (the reference test's bound, tests/test_arch_smoke.py)
against the text-only forward of the same weights: the dense path over
`blocks`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.launch import specs as tspecs
from repro_torch.launch.serve import greedy_decode, main as serve_main
from repro_torch.launch.steps import build_prefill_step, build_train_step, prefill_logits
from repro_torch.models import LM
from repro_torch.models.mlp import MLPParams
from repro_torch.tree_util import tree_flatten, tree_unflatten

ARCH = "internvl2-2b"
CPU = "cpu"
B = 2
REL = 1e-5


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
    jparams = jlm.init(jax.random.PRNGKey(3), jnp.float32)
    params = params_from_numpy(_np(jparams), device=CPU)
    return jlm, jparams, params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _tokens(S, seed):
    return np.random.default_rng(seed).integers(0, 512, size=(B, S), dtype=np.int32)


def _batch(S, seed):
    toks = _tokens(S, seed)
    patches = np.random.default_rng(seed + 100).normal(size=(B, 4, 256)).astype(np.float32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1), "patches": patches}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_params_round_trip_and_count(case):
    jlm, jparams, params = case
    cfg = get_config(ARCH).reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.n_patches) == (
        2, 256, 4, 2, 4)
    assert sorted(params) == sorted(jparams) == ["blocks", "embed", "ln_f", "patch_proj",
                                                 "unembed"]
    assert isinstance(params["blocks"]["ffn"], MLPParams)
    for t, a in zip(tree_flatten(params)[0], jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    n = sum(a.size for a in jax.tree_util.tree_leaves(jparams))
    assert cfg.param_count() == n == 1_508_608
    mine = LM(cfg).init(seed=0, device=CPU)
    assert (jax.tree_util.tree_map(lambda t: tuple(t.shape), mine)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(jparams)))
    # the reference leaves out patch_proj (d^2) and the final norm (d)
    full = get_config(ARCH)
    assert full.param_count() == 1_893_341_184
    assert full.param_count() - jax_get_config(ARCH).param_count() == 2048 ** 2 + 2048


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_forward_and_logits_match_reference(case, backend):
    """The patches prepended, run through the stack and stripped: hiddens of
    the text positions only."""
    jlm, jparams, params = case
    jb, tb = _both(_batch(12, seed=3))
    want, _ = jlm.forward(jparams, jb)
    lm = LM(get_config(ARCH).reduced(), attn_backend=backend)
    got, aux = lm.forward_aux(params, tb)
    assert tuple(got.shape) == (B, 12, 256) and float(aux) == 0.0
    _close(got.numpy(), want)
    _close(prefill_logits(lm, params, tb).numpy(),
           jnp.einsum("bd,dv->bv", want[:, -1], jlm._unembed(jparams)))


def test_loss_and_gradient_match_reference(case):
    jlm, jparams, params = case
    jb, tb = _both(_batch(10, seed=4))
    lm = LM(get_config(ARCH).reduced())
    jl, jg = jax.value_and_grad(lambda p: jlm.loss(p, jb)[0])(jparams)
    leaves, treedef = tree_flatten(params)
    live = [t.detach().clone().requires_grad_(True) for t in leaves]
    loss = lm.loss(tree_unflatten(treedef, live), tb)[0]
    assert float(loss.detach()) == pytest.approx(float(jl), abs=1e-5)
    grads = torch.autograd.grad(loss, live)
    jgrads = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(jgrads) == 13
    for g, want in zip(grads, jgrads):
        _close(g.numpy(), want, 1e-4)
    # patch_proj (sorted last but one) learns from the text's loss
    assert float(grads[-2].abs().max()) > 0


def test_cache_and_decode_match_reference(case):
    """init_cache as the dense family's; 8 decode steps against the
    reference's, the last 4 from its own cache carried across."""
    jlm, jparams, params = case
    lm = LM(get_config(ARCH).reduced())
    jcache = jlm.init_cache(B, 12, dtype=jnp.float32)
    cache = lm.init_cache(B, 12, dtype=torch.float32, device=CPU)
    assert sorted(cache) == sorted(jcache) == ["kv"]
    assert [tuple(t.shape) for t in cache["kv"]] == [a.shape for a in jcache["kv"]]
    toks = _tokens(12, seed=6)
    for t in range(8):
        if t == 4:
            cache = cache_from_numpy(_np(jcache), device=CPU)
        jl, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, cache = lm.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl.numpy(), jl)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_decode_matches_the_text_forward_inside_the_port(case, backend):
    _, _, params = case
    cfg = get_config(ARCH).reduced()
    lm = LM(cfg, attn_backend=backend)
    text = LM(dataclasses.replace(cfg, family="dense", n_patches=0), attn_backend=backend)
    toks = torch.from_numpy(_tokens(14, seed=7))
    dense = {k: v for k, v in params.items() if k != "patch_proj"}
    full = torch.einsum("bsd,dv->bsv", text.forward(dense, {"tokens": toks}),
                        text._unembed(dense))
    cache = lm.init_cache(B, 14, dtype=torch.float32, device=CPU)
    err = 0.0
    for t in range(14):
        lg, cache = lm.decode_step(params, cache, toks[:, t:t + 1], t)
        err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
    assert err < 5e-3, err


def test_greedy_decode_matches_the_reference_loop(case):
    jlm, jparams, params = case
    lm = LM(get_config(ARCH).reduced())
    plen, gen = 4, 6
    total = plen + gen
    prompt = _tokens(plen, seed=8)
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
    seqs, got = greedy_decode(lm, params, lm.init_cache(B, total, dtype=torch.float32, device=CPU),
                              torch.from_numpy(prompt), gen)
    _close(got.numpy(), np.stack(logits, axis=1))
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jnp.concatenate(out, axis=1)))


def test_specs_and_builders_take_the_family(case):
    """train_batch_specs carries `patches` and S - n_patches text tokens as
    the reference's does; the prefill bundle equals the reference's prefill
    on real tensors; one build_train_step round at microbatch granularity
    runs and stays finite."""
    from repro.launch import specs as jspecs
    from repro_torch import random as trandom
    from repro_torch.federation.deep import init_state
    from repro_torch.launch.steps import default_async_cfg
    jlm, jparams, params = case
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    shape = ShapeConfig("t", 12, 4, "train")
    for mb in (0, 2):
        got = tspecs.train_batch_specs(cfg, shape, microbatches=mb)
        want = jspecs.train_batch_specs(jcfg, shape, microbatches=mb)
        assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in got.items()} == {
            k: (tuple(a.shape), str(a.dtype)) for k, a in want.items()}
    assert tuple(got["tokens"].shape) == (2, 2, 8) and tuple(got["patches"].shape) == (2, 2, 4,
                                                                                        256)
    lm = LM(cfg)
    jb, tb = _both(_batch(8, seed=10))
    pre = build_prefill_step(cfg, ShapeConfig("p", 12, B, "prefill"), model=lm,
                             dtype=torch.float32)
    x, _ = jlm.forward(jparams, jb)
    _close(pre.step(params, {k: tb[k] for k in ("tokens", "patches")}).numpy(),
           jnp.einsum("bd,dv->bv", x[:, -1], jlm._unembed(jparams)))
    acfg = default_async_cfg(n_owners=2, n_microbatches=2)
    bundle = build_train_step(cfg, shape, model=lm, async_cfg=acfg, dtype=torch.float32,
                              device=CPU)
    assert sorted(bundle.args[1]) == ["labels", "patches", "tokens"]
    big = _batch(8, seed=11)
    big = {k: np.concatenate([v, v[::-1]]) for k, v in big.items()}      # batch 4
    mb = {k: torch.from_numpy(v.reshape((2, 2) + v.shape[1:])) for k, v in big.items()}
    state, _ = bundle.step(init_state(params, acfg, device=CPU), mb,
                           torch.tensor([1], dtype=torch.int32), trandom.PRNGKey(3, device=CPU))
    assert int(state.step) == 1 and all(bool(torch.isfinite(t).all())
                                        for t in tree_flatten(state.theta_L)[0])


def test_train_main_fails_on_the_family_in_both_packages():
    """The launcher's batches carry tokens and labels only, so neither
    package's train.py can feed the patches: both raise KeyError('patches')
    in the forward."""
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main as tmain
    argv = ["--arch", ARCH, "--steps", "1", "--batch", "4", "--seq", "8", "--records", "16"]
    with pytest.raises(KeyError, match="patches"):
        jmain(argv)
    with pytest.raises(KeyError, match="patches"):
        tmain(argv + ["--device", "cpu"])


def test_serve_main_runs_on_the_cpu(capsys):
    seqs = serve_main(["--arch", ARCH, "--batch", "2", "--prompt-len", "3", "--gen", "4",
                       "--device", "cpu"])
    assert seqs.shape == (2, 7)
    assert "internvl2-2b-smoke" in capsys.readouterr().out
