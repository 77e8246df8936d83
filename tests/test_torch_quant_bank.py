"""The port's quantized owner bank (bank_dtype "int8" / "fp8", and the dense
bf16 bank) held against the JAX reference on the CPU.

Both packages run the flat fused engine on the reduced dense LM with the
same weights, batches and keys. The reference runs its kernels' jnp
oracles; the port runs its plain versions on CPU tensors.

Exact across packages: the initial bank (deterministic encode of the same
central row), owner sequences, refusal masks and the reconciled ledger.
Within tolerance: a last-ulp difference in an owner update (the gradients
come from two autodiff systems, see test_torch_federation.py) may flip a
stochastic rounding decision, so codes differ by at most one grid step at
a few elements (4 int8 and 43 fp8 codes of 5.5M here), and scales and the
residual follow. theta_L agrees within 1e-5 except where a later round
gathers such a copy: theta_bar moves by half a step there (2 int8 and 14
fp8 elements of 1,377,536 here). Inside the port the f32
contracts hold bit for bit on every storage: the step loop equals
run_rounds, and a refused round leaves codes, scales and residual
untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federation as jfed
import repro_torch.federation as tfed
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.federation.deep import _CODEC_SALT as JAX_CODEC_SALT
from repro.kernels.bank_codec import ops as jops
from repro.models import build_model as jax_build_model
from repro_torch import random as trandom
from repro_torch.configs.base import DENSE_124M
from repro_torch.convert import params_from_numpy, quant_bank_from_numpy
from repro_torch.federation import BankCodec, QuantBank, as_bank_codec
from repro_torch.federation.deep import _encode_bank_row
from repro_torch.federation.flatten import init_flat_bank, pack_params
from repro_torch.kernels.bank_codec import ops as tops
from repro_torch.models import LM

CPU = "cpu"
FMTS = ("int8", "fp8")
N, K, G, B, S = 4, 12, 2, 4, 16
THETA_ATOL = 1e-5

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
    toks = np.random.default_rng(0).integers(0, JAX_REDUCED.vocab, size=(K, B, S),
                                             dtype=np.int32)
    return jlm, jparams, {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}


def _owners(fed_mod):
    return [fed_mod.DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0) for i in range(N)]


def _fcfg(fed_mod, horizon=2):
    return fed_mod.FederationConfig.from_target_lr(0.05, n_owners=N, horizon=horizon,
                                                   sigma=1e-2, theta_max=100.0)


def _priv(fed_mod):
    return fed_mod.PrivatizerConfig(xi=1.0, granularity="microbatch", n_microbatches=G,
                                    fused_kernel=True)


def _torch_session(jparams, bank_dtype, horizon=2):
    lm = LM(DENSE_124M.reduced())
    fed = tfed.Federation(_owners(tfed), _fcfg(tfed, horizon), device=CPU)
    fed.make_step(lambda p, b: lm.loss(p, b)[0], privatizer=_priv(tfed), pack_params=True,
                  bank_dtype=bank_dtype)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    return fed, fed.init_state(params)


def _jax_session(lm_case, bank_dtype):
    jlm, jparams, _ = lm_case
    fed = jfed.Federation(_owners(jfed), _fcfg(jfed))
    fed.make_step(lambda p, b: jlm.loss(p, b)[0], privatizer=_priv(jfed), pack_params=True,
                  bank_dtype=bank_dtype)
    return fed, fed.init_state(jparams)


def _np(t):
    return t.detach().cpu().numpy()


def _ledger_parity(led_torch, led_jax):
    assert set(led_torch) == set(led_jax)
    for i, row in led_torch.items():
        assert row == {k: led_jax[i][k] for k in row}, i


def _bank_arrays(bank):
    """(codes as int32, scales, residual) of either package's QuantBank."""
    codes = np.asarray(bank.codes)
    if codes.dtype.itemsize == 1 and codes.dtype != np.int8:
        codes = codes.view(np.uint8)
    return codes.astype(np.int32), np.asarray(bank.scales), np.asarray(bank.residual)


# ------------------------- the slice against the reference -------------------------
@pytest.mark.parametrize("fmt", FMTS)
def test_reduced_lm_quant_bank_matches_reference(lm_case, fmt):
    _, jparams, data = lm_case
    jf, js = _jax_session(lm_case, fmt)
    tf, ts = _torch_session(jparams, fmt)
    # the initial bank: the same deterministic encode of the same central row
    j_init, t_init = _bank_arrays(js.bank), [_np(a) for a in (ts.bank.codes, ts.bank.scales,
                                                            ts.bank.residual)]
    np.testing.assert_array_equal(t_init[0].astype(np.int32), j_init[0])
    np.testing.assert_array_equal(t_init[1], j_init[1])
    np.testing.assert_array_equal(t_init[2], j_init[2])

    js, jm = jf.run_rounds(js, {k: jnp.asarray(v) for k, v in data.items()},
                           key=jax.random.PRNGKey(5))
    ts, tm = tf.run_rounds(ts, {k: torch.from_numpy(v) for k, v in data.items()},
                           key=trandom.PRNGKey(5, device=CPU))
    np.testing.assert_array_equal(_np(tm["owner"]), np.asarray(jm["owner"]))
    refused = _np(tm["refused"])
    np.testing.assert_array_equal(refused, np.asarray(jm["refused"]))
    assert refused.any() and not refused.all()                 # refusal really bites
    _ledger_parity(tf.reconcile(ts), jf.reconcile(js))
    j_codes, j_scales, j_res = _bank_arrays(js.bank)
    t_codes, _, t_res = _bank_arrays(ts.bank)
    # a grid step is scale (int8) or up to 32 * scale (fp8, the top binade)
    step = float(j_scales.max()) * (1.0 if fmt == "int8" else 32.0)
    # the codes differ by at most one grid step (adjacent bit patterns),
    # where a last-ulp difference flipped a rounding decision
    assert np.abs(t_codes - j_codes).max() <= 1
    assert (t_codes != j_codes).mean() <= 1e-4
    np.testing.assert_allclose(_np(ts.bank.scales), j_scales, rtol=1e-6, atol=0)
    assert np.abs(t_res - j_res).max() <= step
    assert np.abs(j_res).max() > 0                               # error feedback is live
    # theta_L within 1e-5, except where a later round gathered a copy with
    # a flipped code: theta_bar, and with it theta_L, then moves by half a
    # step at that element
    dtheta = np.abs(_np(ts.theta_L.buf) - np.asarray(js.theta_L.buf))
    assert (dtheta > THETA_ATOL).mean() <= 1e-4
    assert dtheta.max() <= step / 2 + THETA_ATOL


def test_bf16_bank_matches_reference(lm_case):
    _, jparams, data = lm_case
    jf, js = _jax_session(lm_case, jnp.bfloat16)
    tf, ts = _torch_session(jparams, torch.bfloat16)
    assert ts.bank.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ts.bank.float()), np.asarray(js.bank, np.float32))
    js, jm = jf.run_rounds(js, {k: jnp.asarray(v) for k, v in data.items()},
                           key=jax.random.PRNGKey(5))
    ts, tm = tf.run_rounds(ts, {k: torch.from_numpy(v) for k, v in data.items()},
                           key=trandom.PRNGKey(5, device=CPU))
    np.testing.assert_array_equal(_np(tm["refused"]), np.asarray(jm["refused"]))
    _ledger_parity(tf.reconcile(ts), jf.reconcile(js))
    np.testing.assert_allclose(_np(ts.theta_L.buf), np.asarray(js.theta_L.buf),
                               rtol=0, atol=THETA_ATOL)
    # one bf16 ulp at most, where an f32 difference crosses a rounding boundary
    np.testing.assert_allclose(_np(ts.bank.float()), np.asarray(js.bank, np.float32),
                               rtol=2.0 ** -7, atol=1e-6)


def test_block_scaled_bank_matches_reference():
    # per-block scales: the plain version only, in both packages
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal(2500).astype(np.float32) * 0.3,
              "b": np.float32(0.7)}
    jbank = jfed.init_flat_bank(jfed.pack_params({k: jnp.asarray(v) for k, v in params.items()}),
                                3, jfed.BankCodec("fp8", block_elems=700))
    tbank = init_flat_bank(pack_params({k: torch.tensor(v) for k, v in params.items()},
                                       device=CPU), 3, BankCodec("fp8", block_elems=700))
    codes, scales, _ = _bank_arrays(jbank)
    assert tbank.scales.shape == (3, 4)
    np.testing.assert_array_equal(_np(tbank.codes).astype(np.int32), codes)
    np.testing.assert_array_equal(_np(tbank.scales), scales)
    np.testing.assert_array_equal(_np(tbank.decode_rows()), np.asarray(jbank.decode_rows()))


def test_codec_key_is_the_salted_round_key():
    # the engine's encode under a round key rounds with the bits the
    # reference's engine draws: its codec under fold_in(key, _CODEC_SALT)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(3001).astype(np.float32))
    key = trandom.PRNGKey(77, device=CPU)
    for fmt in FMTS:
        bank = init_flat_bank(pack_params({"w": torch.zeros(3001)}, device=CPU), 2, fmt)
        codes, scales, err = _encode_bank_row(bank, x, key)
        jc, js, je = jops.encode_row(jnp.asarray(x.numpy()),
                                     jax.random.fold_in(jax.random.PRNGKey(77), JAX_CODEC_SALT),
                                     fmt, interpret="oracle")
        np.testing.assert_array_equal(np.asarray(jc).view(np.uint8), _np(codes).view(np.uint8))
        np.testing.assert_array_equal(np.asarray(js), _np(scales))
        np.testing.assert_array_equal(np.asarray(je), _np(err))
        # and not with the unsalted key's bits
        jc0, _, _ = jops.encode_row(jnp.asarray(x.numpy()), jax.random.PRNGKey(77), fmt,
                                    interpret="oracle")
        assert not np.array_equal(np.asarray(jc0).view(np.uint8), _np(codes).view(np.uint8))


# ----------------------------- contracts inside the port -----------------------------
@pytest.mark.parametrize("bank_dtype", ["int8", "fp8", torch.bfloat16])
def test_step_loop_equals_run_rounds_bit_for_bit(lm_case, bank_dtype):
    _, jparams, data = lm_case
    owner_seq = [2, 0, 2]
    root = trandom.PRNGKey(9, device=CPU)
    loop, s_loop = _torch_session(jparams, bank_dtype, horizon=10)
    for k, (o, key) in enumerate(zip(owner_seq, trandom.split(root, 3))):
        s_loop, _ = loop.step(s_loop, {n: torch.from_numpy(v[k]) for n, v in data.items()},
                              o, key)
    fused, s_fused = _torch_session(jparams, bank_dtype, horizon=10)
    s_fused, _ = fused.run_rounds(s_fused, {n: torch.from_numpy(v[:3]) for n, v in data.items()},
                                  owner_seq, key=root)
    assert torch.equal(s_loop.theta_L.buf, s_fused.theta_L.buf)
    if isinstance(s_loop.bank, QuantBank):
        for a, b in ((s_loop.bank.codes, s_fused.bank.codes),
                     (s_loop.bank.scales, s_fused.bank.scales),
                     (s_loop.bank.residual, s_fused.bank.residual)):
            assert torch.equal(a, b)
    else:
        assert torch.equal(s_loop.bank, s_fused.bank)


@pytest.mark.parametrize("bank_dtype", ["int8", "fp8", torch.bfloat16])
def test_refused_round_is_bit_exact_no_op(bank_dtype):
    params = {"w": torch.linspace(-1.0, 1.0, 6), "b": torch.zeros(())}
    data = {"x": torch.randn(2, 4, 6, generator=torch.Generator().manual_seed(0)),
            "y": torch.randn(2, 4, generator=torch.Generator().manual_seed(1))}
    fed = tfed.Federation([tfed.DataOwner(n=100, epsilon=1.0, xi=1.0)] * 3,
                          tfed.FederationConfig(horizon=1, sigma=1e-2, theta_max=100.0),
                          device=CPU)
    fed.make_step(lambda p, b: torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2),
                  privatizer=tfed.PrivatizerConfig(xi=1.0, n_microbatches=2, fused_kernel=True),
                  pack_params=True, bank_dtype=bank_dtype)
    state = fed.init_state(params)
    one = {k: v[:1] for k, v in data.items()}
    state, m = fed.run_rounds(state, one, [1], key=trandom.PRNGKey(1, device=CPU))
    assert not bool(m["refused"][0])

    def snapshot(s):
        bank = s.bank
        parts = ((bank.codes, bank.scales, bank.residual) if isinstance(bank, QuantBank)
                 else (bank,))
        return [s.theta_L.buf.clone()] + [t.clone() for t in parts]

    before = snapshot(state)
    if isinstance(state.bank, QuantBank):
        assert bool(state.bank.residual.abs().max() > 0)      # a live residual to keep
    state, m = fed.run_rounds(state, one, [1], key=trandom.PRNGKey(2, device=CPU))
    assert bool(m["refused"][0])
    assert all(torch.equal(a, b) for a, b in zip(snapshot(state), before))
    assert (fed.reconcile(state)[1]["responses"], fed.ledger()[1]["refused"]) == (1, 1)


def test_quant_bank_container_and_conversion():
    flat = pack_params({"w": torch.linspace(-2.0, 2.0, 1000)}, device=CPU)
    bank = init_flat_bank(flat, 5, "int8")
    assert isinstance(bank, QuantBank) and bank.codec == BankCodec("int8")
    assert (bank.n_owners, bank.size, bank.codes.dtype) == (5, 1000, torch.int8)
    assert bank.nbytes == 5 * 1000 + 5 * 4 + 1000 * 4
    assert bank.codes.is_contiguous() and bank.codes.stride() == (1000, 1)
    assert not bool(bank.residual.any())
    rows = bank.decode_rows()
    assert rows.shape == (5, 1000) and (rows - flat.buf).abs().max() <= bank.scales.max() / 2
    again = quant_bank_from_numpy(_np(bank.codes), _np(bank.scales), _np(bank.residual),
                                  "int8", device=CPU)
    assert torch.equal(again.codes, bank.codes) and torch.equal(again.scales, bank.scales)
    assert bank.replace(residual=bank.residual + 1).codes is bank.codes
    fp8 = init_flat_bank(flat, 2, "fp8")
    assert fp8.codes.dtype == torch.uint8
    assert as_bank_codec(None) is None and as_bank_codec(torch.bfloat16) is None
    with pytest.raises(ValueError):
        as_bank_codec("int4")
    with pytest.raises(ValueError):
        BankCodec("int8", block_elems=0)
