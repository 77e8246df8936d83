"""Activation checkpointing (the reference's `LM(remat=, remat_groups=)`),
on the CPU.

  * For every family at its reduced config, the loss gradient with remat
    on equals remat off BIT FOR BIT (the recompute runs the same ops on
    the same inputs), and so does `remat_groups` on the dense and moe
    stacks (four layers: G = 2 and G = 1, both levels checkpointed).
  * The checkpointed units are the reference's: a dense layer runs once
    without remat, twice with it (the forward and the backward's
    recompute), and under remat_groups the group's recompute runs its
    layers again, each itself checkpointed; a hybrid group of
    `attn_every` Mamba2 layers and the shared block is one unit; the
    xLSTM has none.
  * Under torch.no_grad (prefill, decode) nothing is checkpointed or
    recomputed and the logits are remat off's.
  * Per-example clipping runs with remat on (torch.func transforms
    refuse checkpointing's hooks, so the units run as they stand there)
    and equals remat off bit for bit, on the pytree privatizer and on the
    fused flat engine.
  * The port's gradient with remat on agrees with the reference's
    (`build_model(cfg)`, remat on; remat_groups=1 for the dense one) to
    the tolerances of the port's gradient tests (1e-4 of each leaf's
    largest |gradient|; the onehot MoE 2^-7, its bf16 dispatch).
  * The launchers build their models with remat=False, as the
    reference's `launch/train.py` and `launch/serve.py` do.

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_remat.py
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import LM
from repro_torch.models import model as model_mod
from repro_torch.tree_util import tree_flatten, tree_unflatten

CPU = "cpu"
FAMILIES = ["yi-6b", "qwen3-moe-30b-a3b", "zamba2-2.7b", "xlstm-125m", "internvl2-2b",
            "whisper-medium"]
B, S = 2, 48


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(B, cfg.n_patches, cfg.d_model, generator=g)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(B, cfg.enc_seq, cfg.d_model, generator=g)
    return batch


def _grads(lm, params, batch):
    leaves, treedef = tree_flatten(params)
    live = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss = lm.loss(tree_unflatten(treedef, live), batch)[0]
    return loss.detach(), torch.autograd.grad(loss, live, allow_unused=True)


def _assert_bit_exact(a, b):
    (la, ga), (lb, gb) = a, b
    assert torch.equal(la, lb)
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gradient_is_bit_exact(arch):
    cfg = get_config(arch).reduced()
    params = LM(cfg).init(seed=0, device=CPU)
    batch = _batch(cfg)
    _assert_bit_exact(_grads(LM(cfg, remat=False), params, batch),
                      _grads(LM(cfg, remat=True), params, batch))


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("groups", [1, 2])
def test_remat_groups_gradient_is_bit_exact(arch, groups):
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=4)
    params = LM(cfg).init(seed=0, device=CPU)
    batch = _batch(cfg)
    _assert_bit_exact(_grads(LM(cfg, remat=False), params, batch),
                      _grads(LM(cfg, remat_groups=groups), params, batch))


def _count(monkeypatch, name):
    calls = []
    fn = getattr(LM, name)

    def counted(self, *a, **kw):
        calls.append(1)
        return fn(self, *a, **kw)
    monkeypatch.setattr(LM, name, counted)
    return calls


@pytest.mark.parametrize("kw,runs", [({"remat": False}, 4), ({}, 8), ({"remat_groups": 2}, 10),
                                     ({"remat_groups": 1}, 11)],
                         ids=["off", "on", "groups2", "groups1"])
def test_dense_layers_run_once_per_pass(monkeypatch, kw, runs):
    """Four layers: the forward runs each once; remat's backward recomputes
    each; under G groups the group's recompute also runs its layers up to
    the last one's input (torch's non-reentrant checkpoint stops a
    recompute once what the backward needs is back), n_layers - G more."""
    cfg = dataclasses.replace(get_config("yi-6b").reduced(), n_layers=4)
    params = LM(cfg).init(seed=0, device=CPU)
    calls = _count(monkeypatch, "_dense_layer")
    _grads(LM(cfg, **kw), params, _batch(cfg))
    assert len(calls) == runs


def test_hybrid_groups_are_the_units_and_the_xlstm_has_none(monkeypatch):
    cfg = get_config("zamba2-2.7b").reduced()
    params = LM(cfg).init(seed=0, device=CPU)
    calls = _count(monkeypatch, "_hybrid_group")
    _grads(LM(cfg), params, _batch(cfg))
    assert len(calls) == 2 * cfg.n_layers // cfg.attn_every
    xcfg = get_config("xlstm-125m").reduced()
    remat = _count(monkeypatch, "_maybe_remat")
    _grads(LM(xcfg), LM(xcfg).init(seed=0, device=CPU), _batch(xcfg))
    assert not remat


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-2.7b", "whisper-medium"])
def test_no_grad_prefill_and_decode_do_not_recompute(monkeypatch, arch):
    from repro_torch.launch.steps import prefill_logits
    cfg = get_config(arch).reduced()
    params = LM(cfg).init(seed=0, device=CPU)
    batch = _batch(cfg)
    batch.pop("labels")
    checkpoints = []
    real = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        checkpoints.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    out = {}
    for remat in (False, True):
        lm = LM(cfg, remat=remat)
        with torch.no_grad():
            logits = prefill_logits(lm, params, batch)
            cache = lm.init_cache(B, 4, dtype=torch.float32, device=CPU)
            if cfg.family == "audio":
                cache = lm.prime_cross_cache(params, cache, batch["frames"])
            steps = [lm.decode_step(params, cache, batch["tokens"][:, t:t + 1], t)[0]
                     for t in range(3)]
        out[remat] = [logits] + steps
    assert not checkpoints
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))


def test_example_granularity_runs_with_remat_on_both_paths():
    from repro_torch import random
    from repro_torch.federation.deep import AsyncDPConfig, init_state_flat, make_train_step
    from repro_torch.federation.dp_sgd import PrivatizerConfig, private_grad
    cfg = get_config("yi-6b").reduced()
    params = LM(cfg).init(seed=0, device=CPU)
    batch = _batch(cfg)
    batch = {k: v[:, :16] for k, v in batch.items()}
    key = random.PRNGKey(3, device=CPU)
    pcfg = PrivatizerConfig(xi=1.0, granularity="example")
    out = {}
    for remat in (False, True):
        lm = LM(cfg, remat=remat)

        def loss_fn(p, b):
            return lm.loss(p, b)[0]
        noisy, m = private_grad(loss_fn, params, batch, key, cfg=pcfg, noise_scale=0.01)
        acfg = AsyncDPConfig(n_owners=2, horizon=10, epsilons=(1.0, 1.0),
                             owner_sizes=(100, 100),
                             privatizer=dataclasses.replace(pcfg, fused_kernel=True))
        state = init_state_flat(params, acfg, device=CPU)
        state, fm = make_train_step(loss_fn, acfg, device=CPU)(
            state, batch, torch.tensor([1]), key)
        out[remat] = (tree_flatten(noisy)[0] + [m["max_grad_norm"], state.theta_L.buf,
                                                 state.bank, fm["max_grad_norm"]])
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))


REFERENCE_CASES = [("yi-6b", {"remat_groups": 1}, 1e-4), ("zamba2-2.7b", {}, 1e-4),
                   ("qwen3-moe-30b-a3b", {}, 2.0 ** -7)]


@pytest.mark.parametrize("arch,kw,tol", REFERENCE_CASES, ids=[c[0] for c in REFERENCE_CASES])
def test_remat_gradient_agrees_with_the_reference(arch, kw, tol):
    jcfg = jget_config(arch).reduced()
    jlm = jax_build_model(jcfg, **kw)
    assert jlm.remat
    jparams = jlm.init(jax.random.PRNGKey(2), jnp.float32)
    cfg = get_config(arch).reduced()
    batch = _batch(cfg, seed=4)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jgrads = jax.tree_util.tree_leaves(jax.grad(lambda p: jlm.loss(p, jb)[0])(jparams))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    _, grads = _grads(LM(cfg, **kw), params, batch)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        want = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=tol * float(np.abs(want).max()) + 1e-12)


def test_the_launchers_build_their_models_without_remat(monkeypatch):
    from repro_torch.launch import serve, train

    class Built(Exception):
        pass
    seen = []

    def record(cfg, **kw):
        seen.append(kw)
        raise Built
    for mod in (train, serve):
        monkeypatch.setattr(mod, "build_model", record)
        with pytest.raises(Built):
            mod.main(["--arch", "yi-6b", "--device", "cpu"])
    assert len(seen) == 2 and all(kw.get("remat") is False for kw in seen)
    assert model_mod.build_model(get_config("yi-6b").reduced()).remat
