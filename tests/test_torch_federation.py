"""The port's federation slice held against the JAX reference on the CPU.

Both packages run the flat engine with the fused microbatch privatizer
(`make_step(..., pack_params=True, privatizer=PrivatizerConfig(
fused_kernel=True))`) on the same weights, batches and keys. The reference
runs its kernels' jnp oracles off the TPU; the port runs its plain
versions on CPU tensors.

Exact across packages: owner sequences, refusal masks and the reconciled
ledger (integer streams and host logic). theta_L and the bank agree to a
float tolerance: the gradients come from two autodiff systems with other
summation orders (about 1e-6 relative, see test_torch_model.py), the
clip-norm sums differ in order, and log1p in the Laplace transform may
differ by an ulp (test_torch_dp_clip_noise.py). Inside the port the
reference's own contracts hold bit for bit: the step loop equals
run_rounds, and a refused round is a no-op.
"""
import os
import subprocess
import sys

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
from repro_torch.federation import (DataOwner, Federation, FederationConfig,
                                    LedgerDriftError, PrivatizerConfig, as_owner_seq)
from repro_torch.federation.flatten import pack_params
from repro_torch.federation.privacy import make_device_ledger
from repro_torch.models import LM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
# float tolerance of params/bank across packages (see module docstring)
RTOL, ATOL = 1e-4, 1e-6

# the reduced DENSE_124M in the reference's own config class
JAX_REDUCED = JaxModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab=50304).reduced()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ledger_parity(led_torch, led_jax):
    """The port's ledger keys equal the reference's; the reference's extra
    fault/staleness columns are all zero on this path."""
    assert set(led_torch) == set(led_jax)
    for i, row in led_torch.items():
        jrow = led_jax[i]
        assert row == {k: jrow[k] for k in row}, i
        assert all(jrow[k] == 0 for k in set(jrow) - set(row)), i


def _to_np(t):
    return t.detach().cpu().numpy()


# ------------------------------ reduced LM ---------------------------------
N_LM, K_LM, G_LM, B_LM, S_LM = 4, 6, 2, 4, 16


@pytest.fixture(scope="module")
def lm_case():
    jlm = jax_build_model(JAX_REDUCED, remat=False)
    jparams = jlm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, JAX_REDUCED.vocab, size=(K_LM + 2, B_LM, S_LM),
                        dtype=np.int32)
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    return jlm, jparams, data


def _lm_fcfg(fed_mod):
    return fed_mod.FederationConfig.from_target_lr(
        0.05, n_owners=N_LM, horizon=2, sigma=1e-2, theta_max=100.0)


def _lm_priv(fed_mod, n_microbatches=G_LM):
    return fed_mod.PrivatizerConfig(xi=1.0, granularity="microbatch",
                                    n_microbatches=n_microbatches, fused_kernel=True)


def _lm_owners(fed_mod):
    return [fed_mod.DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0)
            for i in range(N_LM)]


def _run_jax_lm(lm_case, n_microbatches):
    jlm, jparams, data = lm_case
    fed = jfed.Federation(_lm_owners(jfed), _lm_fcfg(jfed))
    fed.make_step(lambda p, b: jlm.loss(p, b)[0], privatizer=_lm_priv(jfed, n_microbatches),
                  pack_params=True)
    state = fed.init_state(jparams)
    batches = {k: jnp.asarray(v[:K_LM]) for k, v in data.items()}
    state, ms = fed.run_rounds(state, batches, key=jax.random.PRNGKey(5))
    fed.reconcile(state)
    keys = jax.random.split(jax.random.PRNGKey(6), 2)
    step_refused = []
    for j, owner in enumerate((0, 1)):
        batch = {k: jnp.asarray(v[K_LM + j]) for k, v in data.items()}
        state, m = fed.step(state, batch, owner, keys[j])
        step_refused.append(bool(m["refused"]))
    return dict(owners=np.asarray(ms["owner"]), refused=np.asarray(ms["refused"]),
                step_refused=step_refused, ledger=fed.ledger(),
                theta=np.asarray(state.theta_L.buf), bank=np.asarray(state.bank))


def _run_torch_lm(lm_case, n_microbatches):
    jlm, jparams, data = lm_case
    lm = LM(DENSE_124M.reduced())
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    fed = Federation(_lm_owners(tfed), _lm_fcfg(tfed), device=CPU)
    fed.make_step(lambda p, b: lm.loss(p, b)[0], privatizer=_lm_priv(tfed, n_microbatches),
                  pack_params=True)
    state = fed.init_state(params)
    batches = {k: torch.from_numpy(v[:K_LM]) for k, v in data.items()}
    state, ms = fed.run_rounds(state, batches, key=trandom.PRNGKey(5, device=CPU))
    fed.reconcile(state)
    keys = trandom.split(trandom.PRNGKey(6, device=CPU), 2)
    step_refused = []
    for j, owner in enumerate((0, 1)):
        batch = {k: torch.from_numpy(v[K_LM + j]) for k, v in data.items()}
        state, m = fed.step(state, batch, owner, keys[j])
        step_refused.append(bool(m["refused"]))
    return dict(owners=_to_np(ms["owner"]), refused=_to_np(ms["refused"]),
                step_refused=step_refused, ledger=fed.ledger(),
                theta=_to_np(state.theta_L.buf), bank=_to_np(state.bank))


def _assert_lm_runs_agree(out, ref):
    np.testing.assert_array_equal(out["owners"], ref["owners"])
    np.testing.assert_array_equal(out["refused"], ref["refused"])
    assert out["step_refused"] == ref["step_refused"]
    _ledger_parity(out["ledger"], ref["ledger"])
    assert out["refused"].any() or any(out["step_refused"])   # refusal really bites
    np.testing.assert_allclose(out["theta"], ref["theta"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["bank"], ref["bank"], rtol=RTOL, atol=ATOL)


def test_reduced_lm_matches_reference(lm_case):
    _assert_lm_runs_agree(_run_torch_lm(lm_case, G_LM), _run_jax_lm(lm_case, G_LM))


def test_reduced_lm_single_microbatch_matches_reference(lm_case):
    # G = 1: the reference takes its own no-group branch, the port the
    # general group loop with one group
    _assert_lm_runs_agree(_run_torch_lm(lm_case, 1), _run_jax_lm(lm_case, 1))


# ---------------- 32 owners, horizon 3, K = 160 (toy regime) ----------------
N_TOY, K_TOY = 32, 160


@pytest.fixture(scope="module")
def toy_case():
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal(6).astype(np.float32),
              "b": np.zeros((), np.float32)}
    data = {"x": rng.standard_normal((K_TOY, 4, 6)).astype(np.float32),
            "y": rng.standard_normal((K_TOY, 4)).astype(np.float32)}
    owner_seq = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (K_TOY,), 0, N_TOY))
    return params, data, owner_seq


def _toy_fed(fed_mod, horizon=3, **kw):
    owners = [fed_mod.DataOwner(n=100, epsilon=1.0, xi=1.0) for _ in range(N_TOY)]
    return fed_mod.Federation(owners, fed_mod.FederationConfig(
        horizon=horizon, sigma=1e-2, theta_max=10.0, lr_scale=5.0), **kw)


def _toy_priv(fed_mod):
    return fed_mod.PrivatizerConfig(xi=1.0, granularity="microbatch",
                                    n_microbatches=2, fused_kernel=True)


def _toy_loss_torch(p, b):
    return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _torch_toy_fed(horizon=3):
    fed = _toy_fed(tfed, horizon=horizon, device=CPU)
    fed.make_step(_toy_loss_torch, privatizer=_toy_priv(tfed), pack_params=True)
    return fed


def _torch_params(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def test_toy_32_owners_refusals_and_ledger_match_reference(toy_case):
    params, data, owner_seq = toy_case
    jf = _toy_fed(jfed)
    jf.make_step(lambda p, b: jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2),
                 privatizer=_toy_priv(jfed), pack_params=True)
    js = jf.init_state({k: jnp.asarray(v) for k, v in params.items()})
    js, jm = jf.run_rounds(js, {k: jnp.asarray(v) for k, v in data.items()},
                           jnp.asarray(owner_seq), key=jax.random.PRNGKey(4))

    tf = _torch_toy_fed()
    ts = tf.init_state(_torch_params(params))
    ts, tm = tf.run_rounds(ts, {k: torch.from_numpy(v) for k, v in data.items()},
                           owner_seq, key=trandom.PRNGKey(4, device=CPU))

    refused = _to_np(tm["refused"])
    np.testing.assert_array_equal(refused, np.asarray(jm["refused"]))
    assert refused.sum() > 20 and not refused[-N_TOY:].all()
    _ledger_parity(tf.reconcile(ts), jf.reconcile(js))
    counts = np.bincount(owner_seq, minlength=N_TOY)
    np.testing.assert_array_equal(_to_np(ts.ledger.spent), np.minimum(counts, 3))
    np.testing.assert_array_equal(_to_np(ts.ledger.refused), np.maximum(counts - 3, 0))
    np.testing.assert_allclose(_to_np(ts.theta_L.buf), np.asarray(js.theta_L.buf),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_to_np(ts.bank), np.asarray(js.bank), rtol=RTOL, atol=ATOL)
    assert int(ts.step) == int(js.step) == K_TOY - refused.sum()


# ------------------------- contracts inside the port ------------------------
def test_step_loop_equals_run_rounds_bit_for_bit(toy_case):
    params, data, owner_seq = toy_case
    root = trandom.PRNGKey(4, device=CPU)
    keys = trandom.split(root, K_TOY)

    loop = _torch_toy_fed()
    s_loop = loop.init_state(_torch_params(params))
    refused_loop = []
    for k in range(K_TOY):
        batch = {name: torch.from_numpy(v[k]) for name, v in data.items()}
        s_loop, m = loop.step(s_loop, batch, int(owner_seq[k]), keys[k])
        refused_loop.append(m["refused"])

    fused = _torch_toy_fed()
    s_fused = fused.init_state(_torch_params(params))
    s_fused, ms = fused.run_rounds(s_fused, {k: torch.from_numpy(v) for k, v in data.items()},
                                   owner_seq, key=root)
    assert refused_loop == _to_np(ms["refused"]).tolist()
    assert torch.equal(s_loop.theta_L.buf, s_fused.theta_L.buf)
    assert torch.equal(s_loop.bank, s_fused.bank)
    assert int(s_loop.step) == int(s_fused.step)
    assert fused.reconcile(s_fused) == loop.ledger()


def test_lm_step_loop_equals_run_rounds_bit_for_bit(lm_case):
    _, jparams, data = lm_case
    lm = LM(DENSE_124M.reduced())

    def session():
        fed = Federation(_lm_owners(tfed), FederationConfig.from_target_lr(
            0.05, n_owners=N_LM, horizon=10, sigma=1e-2), device=CPU)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], privatizer=_lm_priv(tfed),
                      pack_params=True)
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
        return fed, fed.init_state(params)

    owner_seq = [2, 0, 2]
    root = trandom.PRNGKey(9, device=CPU)
    loop, s_loop = session()
    for k, (o, key) in enumerate(zip(owner_seq, trandom.split(root, 3))):
        s_loop, _ = loop.step(s_loop, {n: torch.from_numpy(v[k]) for n, v in data.items()},
                              o, key)
    fused, s_fused = session()
    s_fused, _ = fused.run_rounds(s_fused, {n: torch.from_numpy(v[:3]) for n, v in data.items()},
                                  owner_seq, key=root)
    assert torch.equal(s_loop.theta_L.buf, s_fused.theta_L.buf)
    assert torch.equal(s_loop.bank, s_fused.bank)


def test_refused_round_is_bit_exact_no_op(toy_case):
    params, data, _ = toy_case
    fed = _torch_toy_fed(horizon=1)
    state = fed.init_state(_torch_params(params))
    one = {k: torch.from_numpy(v[:1]) for k, v in data.items()}
    state, m = fed.run_rounds(state, one, [5], key=trandom.PRNGKey(1, device=CPU))
    assert not bool(m["refused"][0])
    theta, bank, step = state.theta_L.buf.clone(), state.bank.clone(), int(state.step)
    state, m = fed.run_rounds(state, one, [5], key=trandom.PRNGKey(2, device=CPU))
    assert bool(m["refused"][0])
    assert torch.equal(state.theta_L.buf, theta)
    assert torch.equal(state.bank, bank)
    assert int(state.step) == step
    led = fed.reconcile(state)
    assert (led[5]["responses"], led[5]["refused"]) == (1, 1)


def test_schedule_drawn_owner_sequence_matches_reference():
    # run_rounds with owner_seq=None: split(key) -> (schedule key, round
    # key), then randint over the owners, in both packages
    key_j, key_t = jax.random.PRNGKey(11), trandom.PRNGKey(11, device=CPU)
    k_sched_j, _ = jax.random.split(key_j)
    k_sched_t, _ = trandom.split(key_t)
    ref = np.asarray(jfed.UniformSchedule().draw(k_sched_j, 7, 50))
    np.testing.assert_array_equal(_to_np(tfed.UniformSchedule().draw(k_sched_t, 7, 50)),
                                  ref)


def test_reconcile_refuses_a_superseded_state(toy_case):
    params, data, owner_seq = toy_case
    fed = _torch_toy_fed()
    stale = fed.init_state(_torch_params(params))
    fed.init_state(_torch_params(params))          # a newer snapshot
    stale, _ = fed.run_rounds(stale, {k: torch.from_numpy(v[:4]) for k, v in data.items()},
                              owner_seq[:4], key=trandom.PRNGKey(0, device=CPU))
    with pytest.raises(LedgerDriftError):
        fed.reconcile(stale)


def test_owner_seq_is_validated(toy_case):
    with pytest.raises(ValueError):
        as_owner_seq([0, 4], 4, device=CPU)
    with pytest.raises(ValueError):
        as_owner_seq([[0, 1]], 4, device=CPU)
    assert as_owner_seq([3, 0], 4, device=CPU).dtype == torch.int32
    params, data, _ = toy_case
    fed = _torch_toy_fed()
    with pytest.raises(ValueError, match="rounds"):
        fed.run_rounds(fed.init_state(_torch_params(params)),
                       {k: torch.from_numpy(v[:3]) for k, v in data.items()}, [0, 1],
                       key=trandom.PRNGKey(0, device=CPU))


def test_federation_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    owners = [DataOwner(n=10, epsilon=1.0, xi=1.0)]
    with pytest.raises(RuntimeError, match="CUDA"):
        Federation(owners, FederationConfig(horizon=3))


@pytest.mark.parametrize("entry", ["PRNGKey", "LM.init", "pack_params", "params_from_numpy",
                                   "as_owner_seq", "make_device_ledger"])
def test_entry_points_without_device_raise_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    calls = {
        "PRNGKey": lambda: trandom.PRNGKey(0),
        "LM.init": lambda: LM(DENSE_124M.reduced()).init(seed=0),
        "pack_params": lambda: pack_params({"w": torch.zeros(3)}),
        "params_from_numpy": lambda: params_from_numpy({"w": np.zeros(3, np.float32)}),
        "as_owner_seq": lambda: as_owner_seq([0], 1),
        "make_device_ledger": lambda: make_device_ledger([1]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_unported_modes_raise(toy_case):
    # the pytree path, the flat reference mode and, since per-example
    # clipping came to the fused flat engine, example granularity there all
    # run; a granularity or a mechanism neither package has is refused
    params, data, _ = toy_case
    batch = {k: torch.from_numpy(v[0]) for k, v in data.items()}
    fed = Federation([DataOwner(n=10, epsilon=1.0, xi=1.0)], FederationConfig(horizon=3),
                     device=CPU)
    fed.make_step(_toy_loss_torch, pack_params=True,
                  privatizer=PrivatizerConfig(xi=1.0, granularity="example",
                                              fused_kernel=True))
    state, m = fed.step(fed.init_state(_torch_params(params)), batch, 0,
                        trandom.PRNGKey(0, device=CPU))
    assert not m["refused"] and 0.0 <= float(m["clip_frac"]) <= 1.0
    assert torch.isfinite(state.theta_L.buf).all()
    fed = Federation([DataOwner(n=10, epsilon=1.0, xi=1.0)], FederationConfig(horizon=3),
                     device=CPU)
    fed.make_step(_toy_loss_torch, pack_params=True,
                  privatizer=PrivatizerConfig(xi=1.0, granularity="token", fused_kernel=True))
    with pytest.raises(ValueError, match="token"):
        fed.step(fed.init_state(_torch_params(params)), batch, 0, trandom.PRNGKey(0, device=CPU))
    with pytest.raises(ValueError, match="unknown mechanism"):
        Federation([DataOwner(n=10, epsilon=1.0, xi=1.0)], FederationConfig(horizon=3),
                   mechanism="gaussian", device=CPU)


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
