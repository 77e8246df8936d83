"""The port's MoE family against the reference on the reduced
qwen3-moe-30b-a3b and mixtral-8x22b (2 layers, d 256, 4 experts, top-2,
d_expert 128; mixtral with its sliding window cut to 64), weights
converted from the reference's init, inputs from a numpy seed.

Tolerances: the router (f32) within 1e-6, its top-k indices exact; the
ragged dispatch (f32 throughout) within 5e-5 on layer outputs and final
hiddens, 1e-5 on the loss, 1e-4 of each leaf's largest |gradient|. The
onehot dispatch copies the reference's bf16 dispatch and combine casts:
both sides round x and the combine weights to bf16, so one bf16 step
(2^-8 relative) of a weight that the two f32 routers put an ulp apart
bounds them: outputs within 2^-8 of their largest value, the loss within
1e-4, gradients within 2^-7 of each leaf's largest |gradient| (their
cotangents pass the same casts). Inside the port, onehot with a capacity
that drops nothing equals ragged within 2^-7 of the largest output: its
bf16 casts of x and of the combine weights each move it by up to a bf16
step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import LM
from repro_torch.models import moe as tmoe

CPU = "cpu"
B = 2
BF16_STEP = 2.0 ** -8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CASES = {}


def _case(arch):
    if arch not in _CASES:
        jcfg = jax_get_config(arch).reduced()
        jparams = jax_build_model(jcfg, remat=False).init(jax.random.PRNGKey(1), jnp.float32)
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
        _CASES[arch] = (jcfg, jparams, params)
    return _CASES[arch]


def _layer(arch):
    """The first layer's MoE params in both packages."""
    jcfg, jparams, params = _case(arch)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["ffn"])
    p = tmoe.MoEParams(*(t[0] for t in params["blocks"]["ffn"]))
    return jcfg.moe, jp, get_config(arch).reduced().moe, p


def _x(S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, 256)).astype(np.float32)


def _close_rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()) + 1e-12)


def _tokens(S, seed):
    return np.random.default_rng(seed).integers(0, 512, size=(B, S), dtype=np.int32)


def test_configs_and_sizes():
    for arch in ("qwen3-moe-30b-a3b", "mixtral-8x22b"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
        red = cfg.reduced().moe
        assert (red.n_experts, red.top_k, red.d_expert) == (4, 2, 128)
        # the port counts every leaf its init makes (the final norm too)
        assert cfg.param_count() == jcfg.param_count() + cfg.d_model
        assert cfg.active_param_count() == jcfg.active_param_count() + cfg.d_model
        _, jparams, params = _case(arch)
        assert cfg.reduced().param_count() == sum(x.size for x in
                                                  jax.tree_util.tree_leaves(jparams))
        assert isinstance(params["blocks"]["ffn"], tmoe.MoEParams)
    assert get_config("qwen3-moe-30b-a3b").param_count() == 30_532_110_336
    assert get_config("mixtral-8x22b").param_count() == 140_630_071_296
    mine = LM(get_config("qwen3-moe-30b-a3b").reduced()).init(seed=0, device=CPU)
    assert mine["blocks"]["ffn"].router.dtype == torch.float32
    assert (jax.tree_util.tree_map(lambda t: tuple(t.shape), mine)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), _case("qwen3-moe-30b-a3b")[1]))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x22b"])
def test_router_matches_reference(arch):
    jm, jp, m, p = _layer(arch)
    x = _x(32, seed=1).reshape(-1, 256)
    jw, jidx, jaux = jmoe._router(jp, jnp.asarray(x), jm)
    w, idx, aux = tmoe._router(p, torch.from_numpy(x), m)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x22b"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_onehot_dispatch_matches_reference(arch, capacity_factor):
    """capacity 0.5 drops tokens (an expert takes at most 8 of a group's 32
    choices), 1.25 the reference's default."""
    jm, jp, m, p = _layer(arch)
    x = _x(16, seed=2)
    jy, jaux = jmoe.moe_forward_onehot(jp, jnp.asarray(x), jm, group_tokens=16,
                                       capacity_factor=capacity_factor)
    y, aux = tmoe.moe_forward_onehot(p, torch.from_numpy(x), m, group_tokens=16,
                                     capacity_factor=capacity_factor)
    assert y.dtype == torch.float32
    _close_rel(y.numpy(), jy, BF16_STEP)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
    if capacity_factor < 1:        # some choices dropped: fewer nonzero token rows slots
        full, _ = tmoe.moe_forward_onehot(p, torch.from_numpy(x), m, group_tokens=16,
                                          capacity_factor=float(m.n_experts) / m.top_k)
        assert not torch.allclose(y, full)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x22b"])
def test_ragged_dispatch_matches_reference_and_onehot_without_drops(arch):
    jm, jp, m, p = _layer(arch)
    x = _x(24, seed=3)
    jy, jaux = jmoe.moe_forward_ragged(jp, jnp.asarray(x), jm)
    y, aux = tmoe.moe_forward_ragged(p, torch.from_numpy(x), m)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=5e-5)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
    # a capacity of every choice of the group: onehot drops nothing and
    # equals ragged up to its bf16 casts of x and of the combine weights
    # (each up to a bf16 step)
    one, _ = tmoe.moe_forward(p, torch.from_numpy(x), m, mode="onehot", group_tokens=48,
                              capacity_factor=float(m.n_experts) / m.top_k)
    _close_rel(one.numpy(), y.numpy(), 2 * BF16_STEP)


def test_ragged_under_vmap_raises_as_the_reference():
    jm, jp, m, p = _layer("qwen3-moe-30b-a3b")
    x = _x(4, seed=4)
    with pytest.raises(NotImplementedError):
        jax.vmap(lambda r: jmoe.moe_forward_ragged(jp, r[None], jm)[0])(jnp.asarray(x))
    with pytest.raises(NotImplementedError, match="vmap"):
        torch.func.vmap(lambda r: tmoe.moe_forward_ragged(p, r[None], m)[0])(torch.from_numpy(x))
    with pytest.raises(NotImplementedError, match="vmap"):
        torch.func.vmap(torch.func.grad(
            lambda r: tmoe.moe_forward_ragged(p, r[None], m)[0].sum()))(torch.from_numpy(x))
    # the onehot dispatch maps, as the reference's does
    got = torch.func.vmap(lambda r: tmoe.moe_forward_onehot(p, r[None], m, group_tokens=4)[0])(
        torch.from_numpy(x))
    assert tuple(got.shape) == (B, 1, 4, 256)
    with pytest.raises(ValueError, match="mode"):
        tmoe.moe_forward(p, torch.from_numpy(x), m, mode="dense")


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x22b"])
@pytest.mark.parametrize("mode", ["onehot", "ragged"])
def test_lm_forward_loss_and_gradient_match_reference(arch, mode):
    """S 80: mixtral's window of 64 cuts in. The loss carries the load-balance
    term, load_balance_coef * aux."""
    from repro_torch.tree_util import tree_flatten, tree_unflatten
    jcfg, jparams, params = _case(arch)
    jlm = jax_build_model(jcfg, remat=False, moe_mode=mode, moe_group_tokens=32)
    lm = LM(get_config(arch).reduced(), moe_mode=mode, moe_group_tokens=32)
    toks = _tokens(80, seed=5)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jx_, jaux = jlm.forward(jparams, jb)
    x, aux = lm.forward_aux(params, tb)
    rel = BF16_STEP if mode == "onehot" else None
    if rel:
        _close_rel(x.numpy(), jx_, rel)
    else:
        np.testing.assert_allclose(x.numpy(), np.asarray(jx_), atol=5e-5)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6) and float(aux) > 0
    jl, jm = jlm.loss(jparams, jb)
    loss, m = lm.loss(params, tb)
    assert float(m["moe_aux"]) == pytest.approx(float(jm["moe_aux"]), abs=1e-6)
    assert float(loss) == pytest.approx(float(m["ce"]) + 0.01 * float(aux), abs=1e-6)
    assert float(loss) == pytest.approx(float(jl), abs=1e-4 if rel else 1e-5)
    jgrads = jax.tree_util.tree_leaves(jax.grad(lambda p: jlm.loss(p, jb)[0])(jparams))
    leaves, treedef = tree_flatten(params)
    live = [t.detach().clone().requires_grad_(True) for t in leaves]
    grads = torch.autograd.grad(lm.loss(tree_unflatten(treedef, live), tb)[0], live)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        _close_rel(g.numpy(), jg, 2 * BF16_STEP if rel else 1e-4)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x22b"])
def test_cache_and_decode_match_reference(arch):
    """Decode runs the batch as one group of B tokens (the reference's
    decode_step); logits within the onehot tolerance of theirs; mixtral's
    cache is a ring of its window."""
    jcfg, jparams, params = _case(arch)
    jlm = jax_build_model(jcfg, remat=False)
    lm = LM(get_config(arch).reduced())
    want = jax.tree_util.tree_map(np.asarray, jlm.init_cache(B, 80, dtype=jnp.float32))
    got = lm.init_cache(B, 80, dtype=torch.float32, device=CPU)
    assert [tuple(t.shape) for t in got["kv"]] == [a.shape for a in want["kv"]]
    toks = _tokens(10, seed=6)
    jcache = jlm.init_cache(B, 10, dtype=jnp.float32)
    cache = lm.init_cache(B, 10, dtype=torch.float32, device=CPU)
    for t in range(10):
        jl, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, cache = lm.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        _close_rel(tl.numpy(), jl, BF16_STEP)
