"""The three dense archs registered last against the reference at their
reduced configs: granite-20b's MQA (Kv 1), qwen1.5-110b's qkv bias (given random
values on both sides: the init's are zeros) and command-r-35b's tied
embedding with RoPE theta 8e6. Both packages' `reduced()` drop
tie_embeddings, so command-r's tied head is a case of its own, built with
`dataclasses.replace(cfg.reduced(), tie_embeddings=True)` on both sides.
(tests/test_torch_launch.py holds all ten archs' configs field for field
against the reference's registry, and each one's meta init against the
reference's init at full width.)

Tolerances: f32 within 1e-5 of the largest value for final hiddens,
prefill logits and decode logits; the loss within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch.steps import prefill_logits
from repro_torch.models import LM

CPU = "cpu"
B = 2
REL = 1e-5
# (case, arch, tied)
CASES = [("granite-mqa", "granite-20b", False), ("qwen1.5-bias", "qwen1.5-110b", False),
         ("command-r-tied", "command-r-35b", True)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


_BUILT = {}


def _case(name):
    """(reference LM, its params, the port's config, the port's params):
    the reduced config (tied for command-r), the reference's init with
    random qkv biases where the arch has them, converted."""
    if name not in _BUILT:
        _, arch, tied = next(c for c in CASES if c[0] == name)
        jcfg = jconfigs.get_config(arch).reduced()
        cfg = tconfigs.get_config(arch).reduced()
        if tied:
            jcfg = dataclasses.replace(jcfg, tie_embeddings=True)
            cfg = dataclasses.replace(cfg, tie_embeddings=True)
        jlm = jax_build_model(jcfg, remat=False)
        jparams = jlm.init(jax.random.PRNGKey(4), jnp.float32)
        if jcfg.qkv_bias:
            rng = np.random.default_rng(1)
            a = jparams["blocks"]["attn"]
            jparams["blocks"]["attn"] = a._replace(**{
                n: jnp.asarray(rng.normal(size=getattr(a, n).shape).astype(np.float32))
                for n in ("bq", "bk", "bv")})
        _BUILT[name] = (jlm, jparams, cfg, params_from_numpy(_np(jparams), device=CPU))
    return _BUILT[name]


def _tokens(S, seed):
    return np.random.default_rng(seed).integers(0, 512, size=(B, S), dtype=np.int32)


def test_reduced_configs_keep_the_features():
    """granite's MQA, qwen1.5's bias and command-r's theta survive
    reduced(); tie_embeddings does not, in either package. qwen1.5's
    source is the reference's field as it stands."""
    assert tconfigs.get_config("qwen1.5-110b").source == "hf:Qwen/Qwen1.5-0.5B"
    g, q, c = (tconfigs.get_config(a).reduced()
               for a in ("granite-20b", "qwen1.5-110b", "command-r-35b"))
    assert (g.n_heads, g.n_kv_heads) == (4, 1)
    assert q.qkv_bias and (q.n_heads, q.n_kv_heads) == (4, 1)
    assert c.rope_theta == 8e6 and not c.tie_embeddings
    assert not jconfigs.get_config("command-r-35b").reduced().tie_embeddings
    jlm, jparams, cfg, params = _case("command-r-tied")
    assert "unembed" not in params and "unembed" not in jparams
    assert cfg.param_count() == sum(a.size for a in jax.tree_util.tree_leaves(jparams))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_forward_loss_and_prefill_match_reference(name, backend):
    jlm, jparams, cfg, params = _case(name)
    toks = _tokens(20, seed=len(name))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    lm = LM(cfg, attn_backend=backend)
    want, _ = jlm.forward(jparams, jb)
    _close(lm.forward(params, tb).numpy(), want)
    _close(prefill_logits(lm, params, tb).numpy(),
           jnp.einsum("bd,dv->bv", want[:, -1], jlm._unembed(jparams)))
    assert float(lm.loss(params, tb)[0]) == pytest.approx(float(jlm.loss(jparams, jb)[0]),
                                                           abs=1e-5)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_decode_matches_reference(name):
    jlm, jparams, cfg, params = _case(name)
    lm = LM(cfg)
    toks = _tokens(6, seed=9)
    jcache = jlm.init_cache(B, 6, dtype=jnp.float32)
    cache = lm.init_cache(B, 6, dtype=torch.float32, device=CPU)
    assert tuple(cache["kv"].k.shape) == jcache["kv"].k.shape
    for t in range(6):
        jl, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, cache = lm.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl.numpy(), jl)
