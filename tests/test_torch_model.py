"""The port's dense LM against repro.models on the reduced DENSE_124M
(2 layers, d 256, vocab 512, S 16), weights converted from the reference,
and the dense decode path on the reduced yi-6b (2 layers, d 256, MQA).

Tolerances: the loss within 1e-5 (one f32 forward, other summation orders
in the matmuls and reductions); the packed flat gradient within 1e-4
relative to its largest element (two autodiff systems over the same
graph); decode logits within 1e-5 per step (f32, logits about 0.3). The
building blocks are compared one by one at tighter bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.federation import flatten as jflatten
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models.model import chunked_lm_loss as jax_chunked_lm_loss
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.configs.base import DENSE_124M
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.federation import flatten as tflatten
from repro_torch.models import LM
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models.model import chunked_lm_loss

JAX_REDUCED = JaxModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab=50304).reduced()
B, S = 4, 16
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    jlm = jax_build_model(JAX_REDUCED, remat=False)
    jparams = jlm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, JAX_REDUCED.vocab, size=(B, S),
                                             dtype=np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    return jlm, jparams, batch


def _f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_reduced_config_matches_reference():
    t = DENSE_124M.reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "head_dim"):
        assert getattr(t, f) == getattr(JAX_REDUCED, f), f
    assert DENSE_124M.param_count() == 152_783_616


def test_loss_matches_reference(case):
    jlm, jparams, batch = case
    ref = float(jlm.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})[0])
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    out = float(LM(DENSE_124M.reduced()).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})[0])
    assert out == pytest.approx(ref, abs=1e-5)


def test_packed_gradient_matches_reference(case):
    jlm, jparams, batch = case
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = np.asarray(jflatten.pack_params(
        jax.grad(lambda p: jlm.loss(p, jb)[0])(jparams)).buf)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    spec = tflatten.flatten_spec(params)
    leaf = spec.pack(params).requires_grad_(True)
    LM(DENSE_124M.reduced()).loss(
        spec.unpack(leaf), {k: torch.from_numpy(v) for k, v in batch.items()})[0].backward()
    err = np.abs(leaf.grad.numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-4, err


def test_rms_norm():
    x, s = _f32((2, 5, 32), 0), _f32((32,), 1)
    ref = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s)))
    np.testing.assert_allclose(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
                               ref, rtol=1e-6, atol=1e-6)


def test_rope():
    pos = np.arange(16)
    jc, js = jlayers.rope_freqs(jnp.asarray(pos), 64, 10000.0)
    tc, ts = tlayers.rope_freqs(torch.from_numpy(pos), 64, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    x = _f32((2, 16, 4, 64), 2)
    ref = np.asarray(jlayers.apply_rope(jnp.asarray(x), jc[None], js[None]))
    out = tlayers.apply_rope(torch.from_numpy(x), tc[None], ts[None]).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_causal_gqa_attention_equals_blockwise_attention():
    q, k, v = _f32((2, 16, 4, 32), 3), _f32((2, 16, 2, 32), 4), _f32((2, 16, 2, 32), 5)
    pos = np.arange(16)
    ref = np.asarray(jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(pos),
        kv_positions=jnp.asarray(pos), causal=True))
    out = tattn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), q_positions=torch.from_numpy(pos),
                                    kv_positions=torch.from_numpy(pos), causal=True).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_attention_forward():
    d, H, Kv, hd = 32, 4, 2, 8
    w = {n: _f32(s, i) for i, (n, s) in enumerate(
        (("wq", (d, H, hd)), ("wk", (d, Kv, hd)), ("wv", (d, Kv, hd)), ("wo", (H, hd, d))))}
    x, pos = _f32((2, 8, d), 9), np.arange(8)
    ref = np.asarray(jattn.attention_forward(
        jattn.AttnParams(**{n: jnp.asarray(a) for n, a in w.items()}), jnp.asarray(x),
        positions=jnp.asarray(pos), rope_theta=10000.0))
    out = tattn.attention_forward(
        tattn.AttnParams(**{n: torch.from_numpy(a) for n, a in w.items()}),
        torch.from_numpy(x), positions=torch.from_numpy(pos), rope_theta=10000.0).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_swiglu_mlp():
    w = [_f32(s, i) for i, s in enumerate(((16, 24), (16, 24), (24, 16)))]
    x = _f32((2, 5, 16), 7)
    ref = np.asarray(jmlp.mlp_forward(jmlp.MLPParams(*map(jnp.asarray, w)), jnp.asarray(x)))
    out = tmlp.mlp_forward(tmlp.MLPParams(*map(torch.from_numpy, w)),
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seq,chunk", [(16, 512), (20, 8)])
def test_chunked_lm_loss(seq, chunk):
    x, u = _f32((2, seq, 16), 11), _f32((16, 40), 12)
    labels = np.random.default_rng(13).integers(-1, 40, size=(2, seq)).astype(np.int32)
    ref = float(jax_chunked_lm_loss(jnp.asarray(x), jnp.asarray(u), jnp.asarray(labels),
                                    chunk=chunk))
    out = float(chunked_lm_loss(torch.from_numpy(x), torch.from_numpy(u),
                                torch.from_numpy(labels), chunk=chunk))
    assert out == pytest.approx(ref, rel=1e-5)


def test_port_init_is_seeded_and_sized():
    lm = LM(DENSE_124M.reduced())
    a, b = lm.init(seed=3, device=CPU), lm.init(seed=3, device=CPU)
    la, _ = tflatten.tree_flatten(a)
    lb, _ = tflatten.tree_flatten(b)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert sum(x.numel() for x in la) == DENSE_124M.reduced().param_count()
    wq = a["blocks"]["attn"].wq
    assert wq.abs().max() <= 2.0 / (256 * 4) ** 0.5 + 1e-6    # truncated at 2 std


@pytest.fixture(scope="module")
def yi_case():
    jcfg = jax_get_config("yi-6b").reduced()
    jlm = jax_build_model(jcfg, remat=False)
    jparams = jlm.init(jax.random.PRNGKey(1), jnp.float32)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    return jlm, jparams, params


def test_yi_reduced_config_matches_reference(yi_case):
    _, jparams, _ = yi_case
    t, j = get_config("yi-6b").reduced(), jax_get_config("yi-6b").reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "head_dim",
              "sliding_window", "long_context_override"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.param_count() == sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    # the reference's analytic count leaves out the final norm's d_model
    assert get_config("yi-6b").param_count() == jax_get_config("yi-6b").param_count() + 4096


@pytest.mark.parametrize("window", [None, 4])
def test_dense_decode_matches_reference(yi_case, window):
    """Decode 10 tokens on a full cache (capacity 10) and on a ring cache
    (window 4, capacity 4), the second half from the reference's cache
    carried across with cache_from_numpy: logits within 1e-5 per step."""
    jlm, jparams, params = yi_case
    lm = LM(get_config("yi-6b").reduced())
    Bd, S = 2, 10
    toks = np.random.default_rng(7).integers(0, 512, size=(Bd, S), dtype=np.int32)
    jcache = jlm.init_cache(Bd, S, window=window, dtype=jnp.float32)
    cache = lm.init_cache(Bd, S, window=window, dtype=torch.float32, device=CPU)
    assert tuple(cache["kv"].k.shape) == jcache["kv"].k.shape
    assert cache["kv"].k.shape[2] == (4 if window else S)
    err = 0.0
    for t in range(S):
        if t == S // 2:
            cache = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache), device=CPU)
            assert isinstance(cache["kv"], tattn.KVCache)
        jl, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                                     jnp.int32(t), window=window)
        tl, cache = lm.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]), t,
                                   window=window)
        err = max(err, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    assert err < 1e-5, err


@pytest.mark.parametrize("window", [None, 4])
def test_dense_decode_matches_forward_inside_the_port(yi_case, window):
    """Inside the port, decode equals the forward with the same window
    within 5e-3 (the reference's own test's bound)."""
    _, _, params = yi_case
    lm = LM(get_config("yi-6b").reduced(), attn_backend="pallas")
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, 512, size=(2, 12),
                                                              dtype=np.int32))
    full = torch.einsum("bsd,dv->bsv", lm.forward(params, {"tokens": toks}, window=window),
                        lm._unembed(params))
    cache = lm.init_cache(2, 12, window=window, dtype=torch.float32, device=CPU)
    for t in range(12):
        lg, cache = lm.decode_step(params, cache, toks[:, t:t + 1], t, window=window)
        assert float((lg[:, 0] - full[:, t]).abs().max()) < 5e-3
