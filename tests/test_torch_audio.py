"""The port's audio family (whisper) against the reference on the reduced
whisper-medium (2 decoder and 2 encoder layers, enc_seq 16, d 256, H = Kv =
4, hd 64, d_ff 512, vocab 512), weights converted from the reference's
init, inputs from a numpy seed.

Tolerances: f32 within 1e-5 of the largest value (`_close`) for
layer_norm, the GELU MLP, the encoder and cross attention, the final
hiddens and logits, the cross K/V of `prime_cross_cache` and every decode
step's logits; the loss within 1e-5; the loss gradient within 1e-4 of each
leaf's largest |gradient| (two autodiff systems sum in other orders);
greedy tokens exactly. The erf form of GELU misses the MLP's bound (it
differs from the tanh form by up to 4.7e-4 an element). Inside the port,
decode equals the forward within 5e-3, the bound of the reference's own
test (tests/test_arch_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.launch import specs as tspecs
from repro_torch.launch.serve import greedy_decode, main as serve_main
from repro_torch.launch.steps import build_prefill_step, build_train_step, prefill_logits
from repro_torch.models import LM
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models.attention import AttnParams, KVCache
from repro_torch.models.mlp import MLPParams
from repro_torch.tree_util import tree_flatten, tree_unflatten

ARCH = "whisper-medium"
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
    jparams = jlm.init(jax.random.PRNGKey(2), jnp.float32)
    params = params_from_numpy(_np(jparams), device=CPU)
    return jlm, jparams, params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _rng(seed):
    return np.random.default_rng(seed)


def _tokens(S, seed):
    return _rng(seed).integers(0, 512, size=(B, S), dtype=np.int32)


def _frames(seed):
    return _rng(seed).normal(size=(B, 16, 256)).astype(np.float32)


def _batch(S, seed):
    toks = _tokens(S, seed)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1), "frames": _frames(seed + 100)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _layer(tree, i=0):
    """Layer i of the reference's tree of stacked leaves."""
    return jax.tree_util.tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = _rng(0)
    x, scale, bias = (rng.normal(size=s).astype(np.float32) * m
                      for s, m in (((B, 7, 256), 3.0), ((256,), 1.0), ((256,), 1.0)))
    x = x + 5.0                                     # a mean far from 0
    want = jlayers.layer_norm(jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(bias))
    got = tlayers.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(scale), torch.from_numpy(bias))
    assert str(got.dtype) == f"torch.{dtype}" and str(want.dtype) == dtype
    if dtype == "float32":
        _close(got.numpy(), want)
    else:                                           # both round the same f32 values to bf16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2 ** -7, atol=1e-5)


def test_gelu_mlp_matches_reference_and_not_the_erf_form(case):
    """mlp_forward with w_gate None is the reference's jax.nn.gelu, the tanh
    form; torch's default erf form misses the bound at this width."""
    _, jparams, params = case
    jp = _layer(jparams["enc_blocks"]["mlp"])
    p = MLPParams(*(None if t is None else t[0] for t in params["enc_blocks"]["mlp"]))
    assert jp.w_gate is None and p.w_gate is None
    x = _rng(1).normal(size=(B, 9, 256)).astype(np.float32)
    want = np.asarray(jmlp.mlp_forward(jp, jnp.asarray(x)))
    got = tmlp.mlp_forward(p, torch.from_numpy(x))
    _close(got.numpy(), want)
    up = torch.einsum("bsd,df->bsf", torch.from_numpy(x), p.w_up)
    erf = torch.einsum("bsf,fd->bsd", F.gelu(up), p.w_down).numpy()
    assert np.abs(erf - want).max() > 10 * REL * np.abs(want).max()
    # init_gelu's leaves: the reference's shapes, no gate
    mine = tmlp.init_gelu(torch.Generator().manual_seed(0), 256, 512)
    assert mine.w_gate is None and tuple(mine.w_up.shape) == (256, 512)
    assert tuple(mine.w_down.shape) == (512, 256)


@pytest.mark.parametrize("bias", [False, True])
def test_encoder_and_cross_attention_match_reference(case, bias):
    """Layer 0's encoder attention and cross attention (whisper's carry no
    bias; `bias` gives both sides the same random q/k/v biases, to reach
    those branches too)."""
    _, jparams, _ = case
    rng = _rng(2)
    jenc = _layer(jparams["enc_blocks"]["attn"])
    jcross = _layer(jparams["blocks"]["cross"])
    if bias:
        def biased(p):
            return p._replace(**{n: jnp.asarray(rng.normal(size=(4, 64)).astype(np.float32))
                                 for n in ("bq", "bk", "bv")})
        jenc, jcross = biased(jenc), biased(jcross)
    enc, cross = (params_from_numpy(_np(p), device=CPU) for p in (jenc, jcross))
    assert isinstance(enc, AttnParams) and (enc.bq is not None) == bias
    x = rng.normal(size=(B, 16, 256)).astype(np.float32)
    q = rng.normal(size=(B, 5, 256)).astype(np.float32)
    _close(tattn.encoder_attention(enc, torch.from_numpy(x)).numpy(),
           jattn.encoder_attention(jenc, jnp.asarray(x)))
    jk, jv = jattn.cross_kv(jcross, jnp.asarray(x))
    k, v = tattn.cross_kv(cross, torch.from_numpy(x))
    assert tuple(k.shape) == (B, 16, 4, 64)
    _close(k.numpy(), jk)
    _close(v.numpy(), jv)
    _close(tattn.cross_attention(cross, torch.from_numpy(q), k, v).numpy(),
           jattn.cross_attention(jcross, jnp.asarray(q), jk, jv))


# ---------------------------------------------------------------- the LM
def test_params_round_trip_and_count(case):
    jlm, jparams, params = case
    cfg = get_config(ARCH).reduced()
    assert sorted(params) == sorted(jparams) == ["blocks", "embed", "enc_blocks", "enc_ln_f",
                                                 "enc_pos", "ln_f", "unembed"]
    assert sorted(params["blocks"]) == ["cross", "ln1", "ln2", "ln3", "mlp", "self"]
    assert sorted(params["enc_blocks"]) == ["attn", "ln1", "ln2", "mlp"]
    assert params["blocks"]["mlp"].w_gate is None and params["enc_blocks"]["attn"].bq is None
    for t, a in zip(tree_flatten(params)[0], jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    n = sum(a.size for a in jax.tree_util.tree_leaves(jparams))
    assert cfg.param_count() == n == 2_890_752
    mine = LM(cfg).init(seed=0, device=CPU)
    assert (jax.tree_util.tree_map(lambda t: tuple(t.shape), mine)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(jparams)))
    # the reference counts the decoder as SwiGLU blocks, without the cross
    # attention, the third norm, enc_pos and enc_ln_f
    assert get_config(ARCH).param_count() == 812_523_520
    assert jax_get_config(ARCH).param_count() == 810_960_896


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_forward_and_logits_match_reference(case, backend):
    jlm, jparams, params = case
    jb, tb = _both(_batch(12, seed=3))
    want, jaux = jlm.forward(jparams, jb)
    lm = LM(get_config(ARCH).reduced(), attn_backend=backend)
    got, aux = lm.forward_aux(params, tb)
    assert tuple(got.shape) == (B, 12, 256) and float(aux) == float(jaux) == 0.0
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
    assert len(grads) == len(jgrads) == 26
    for g, want in zip(grads, jgrads):
        _close(g.numpy(), want, 1e-4)


def test_cache_prime_and_decode_match_reference(case):
    """init_cache's shapes, the primed cross K/V, and 8 decode steps, each
    against the reference's; then the reference's primed cache carried
    across with cache_from_numpy decodes on in the port as in the
    reference."""
    jlm, jparams, params = case
    lm = LM(get_config(ARCH).reduced())
    jcache = jlm.init_cache(B, 12, dtype=jnp.float32)
    cache = lm.init_cache(B, 12, dtype=torch.float32, device=CPU)
    assert sorted(cache) == sorted(jcache) == ["cross", "kv"]
    for name in ("kv", "cross"):
        assert [tuple(t.shape) for t in cache[name]] == [a.shape for a in jcache[name]]
    assert tuple(cache["cross"].k.shape) == (2, B, 16, 4, 64)
    frames = _frames(5)
    jcache = jlm.prime_cross_cache(jparams, jcache, jnp.asarray(frames))
    cache = lm.prime_cross_cache(params, cache, torch.from_numpy(frames))
    _close(cache["cross"].k.numpy(), jcache["cross"].k)
    _close(cache["cross"].v.numpy(), jcache["cross"].v)
    toks = _tokens(12, seed=6)
    for t in range(8):
        if t == 4:                                  # go on from the reference's own cache
            cache = cache_from_numpy(_np(jcache), device=CPU)
            assert isinstance(cache["cross"], KVCache)
        jl, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, cache = lm.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        assert tuple(tl.shape) == (B, 1, 512)
        _close(tl.numpy(), jl)
    # the default bf16 cache primes in its own dtype
    bf = lm.prime_cross_cache(params, lm.init_cache(B, 4, device=CPU), torch.from_numpy(frames))
    assert bf["cross"].k.dtype == torch.bfloat16 and bool(bf["cross"].k.any())


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_decode_matches_forward_inside_the_port(case, backend):
    _, _, params = case
    lm = LM(get_config(ARCH).reduced(), attn_backend=backend)
    b = {k: torch.from_numpy(v) for k, v in _batch(14, seed=7).items()}
    full = torch.einsum("bsd,dv->bsv", lm.forward(params, b), lm._unembed(params))
    cache = lm.prime_cross_cache(params, lm.init_cache(B, 14, dtype=torch.float32, device=CPU),
                                 b["frames"])
    err = 0.0
    for t in range(14):
        lg, cache = lm.decode_step(params, cache, b["tokens"][:, t:t + 1], t)
        err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
    assert err < 5e-3, err


def test_greedy_decode_matches_the_reference_loop(case):
    """greedy_decode after prime_cross_cache against the reference's serve
    loop (serve.py:57-63) written out with its decode_step: every step's
    logits within the bound, the tokens equal."""
    jlm, jparams, params = case
    lm = LM(get_config(ARCH).reduced())
    plen, gen = 4, 6
    total = plen + gen
    prompt, frames = _tokens(plen, seed=8), _frames(9)
    jcache = jlm.prime_cross_cache(jparams, jlm.init_cache(B, total, dtype=jnp.float32),
                                   jnp.asarray(frames))
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
    cache = lm.prime_cross_cache(params, lm.init_cache(B, total, dtype=torch.float32, device=CPU),
                                 torch.from_numpy(frames))
    seqs, got = greedy_decode(lm, params, cache, torch.from_numpy(prompt), gen)
    _close(got.numpy(), np.stack(logits, axis=1))
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jnp.concatenate(out, axis=1)))


# ---------------------------------------------------------------- launch
def test_specs_and_builders_take_the_family(case):
    """train_batch_specs carries `frames` as the reference's does; the
    prefill bundle equals the reference's prefill on real tensors; one
    build_train_step round at microbatch granularity runs and stays
    finite."""
    from repro.launch import specs as jspecs
    from repro_torch import random as trandom
    from repro_torch.federation.deep import init_state
    from repro_torch.launch.steps import default_async_cfg
    jlm, jparams, params = case
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    shape = ShapeConfig("t", 8, 4, "train")
    for mb in (0, 2):
        got = tspecs.train_batch_specs(cfg, shape, microbatches=mb)
        want = jspecs.train_batch_specs(jcfg, shape, microbatches=mb)
        assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in got.items()} == {
            k: (tuple(a.shape), str(a.dtype)) for k, a in want.items()}
    assert tuple(got["frames"].shape) == (2, 2, 16, 256)
    lm = LM(cfg)
    jb, tb = _both(_batch(8, seed=10))
    pre = build_prefill_step(cfg, ShapeConfig("p", 8, B, "prefill"), model=lm,
                             dtype=torch.float32)
    x, _ = jlm.forward(jparams, jb)
    _close(pre.step(params, {k: tb[k] for k in ("tokens", "frames")}).numpy(),
           jnp.einsum("bd,dv->bv", x[:, -1], jlm._unembed(jparams)))
    acfg = default_async_cfg(n_owners=2, n_microbatches=2)
    bundle = build_train_step(cfg, shape, model=lm, async_cfg=acfg, dtype=torch.float32,
                              device=CPU)
    assert sorted(bundle.args[1]) == ["frames", "labels", "tokens"]
    big = _batch(8, seed=11)
    big = {k: np.concatenate([v, v[::-1]]) for k, v in big.items()}      # batch 4
    mb = {k: torch.from_numpy(v.reshape((2, 2) + v.shape[1:])) for k, v in big.items()}
    state, m = bundle.step(init_state(params, acfg, device=CPU), mb,
                           torch.tensor([1], dtype=torch.int32), trandom.PRNGKey(3, device=CPU))
    assert int(state.step) == 1 and all(bool(torch.isfinite(t).all())
                                        for t in tree_flatten(state.theta_L)[0])


def test_train_main_fails_on_the_family_in_both_packages():
    """The launcher's batches carry tokens and labels only, so neither
    package's train.py can feed the encoder: both raise KeyError('frames')
    in the forward."""
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main as tmain
    argv = ["--arch", ARCH, "--steps", "1", "--batch", "4", "--seq", "8", "--records", "16"]
    with pytest.raises(KeyError, match="frames"):
        jmain(argv)
    with pytest.raises(KeyError, match="frames"):
        tmain(argv + ["--device", "cpu"])


def test_serve_main_primes_and_runs_on_the_cpu(capsys):
    seqs = serve_main(["--arch", ARCH, "--batch", "2", "--prompt-len", "3", "--gen", "4",
                       "--device", "cpu"])
    assert seqs.shape == (2, 7)
    assert "whisper-medium-smoke" in capsys.readouterr().out
