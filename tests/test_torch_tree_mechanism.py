"""The port's tree mechanism (DP-FTRL) and capped accountant held against
the JAX reference on the CPU.

Accounting is host logic and matches exactly: scales, caps, capacity, the
ledger with its per-level "tree" view, and the errors. The session runs
the flat fused engine on the reduced dense LM in both packages with the
same weights, batches and keys; the reference runs its kernels' jnp
oracles, the port its plain versions on CPU tensors. Owner sequences,
refused masks, the reconciled ledger and the leaf counts match exactly;
theta_L, the bank and the nodes within test_torch_federation.py's
tolerance, rtol 1e-4 and atol 1e-6 (the gradients come from two autodiff
systems, and log1p may differ by an ulp). Inside
the port the contracts hold bit for bit: depth 0 equals the paper
mechanism, the step loop equals run_rounds, and a refused round leaves
the nodes and counts untouched on every bank storage.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federation as jfed
import repro_torch.federation as tfed
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.federation import deep as jdeep
from repro.models import build_model as jax_build_model
from repro_torch import random as trandom
from repro_torch.configs.base import DENSE_124M
from repro_torch.convert import params_from_numpy, tree_noise_from_numpy
from repro_torch.federation import QuantBank
from repro_torch.models import LM

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-6

JAX_REDUCED = JaxModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab=50304).reduced()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def _ledger_parity(led_torch, led_jax):
    """The port's ledger equals the reference's on every key it has; the
    reference's fault and staleness columns are all zero here."""
    assert set(led_torch) == set(led_jax)
    for i, row in led_torch.items():
        jrow = led_jax[i]
        assert row == {k: jrow[k] for k in row}, i
        assert all(jrow[k] == 0 for k in set(jrow) - set(row)), i


# ----------------------------------- accounting -----------------------------------
def _owners(fed_mod, n=3):
    return [fed_mod.DataOwner(n=100 * (i + 1), epsilon=0.5 * (i + 1), xi=1.0)
            for i in range(n)]


@pytest.mark.parametrize("horizon", [1, 7, 100, 1000])
@pytest.mark.parametrize("depth", [None, 0, 1, 4, 9])
def test_tree_mechanism_matches_reference(horizon, depth):
    jm = jfed.make_mechanism("tree", _owners(jfed), jfed.FederationConfig(horizon=horizon),
                             tree_depth=depth)
    tm = tfed.make_mechanism("tree", _owners(tfed), tfed.FederationConfig(horizon=horizon),
                             tree_depth=depth)
    assert (tm.tree_depth, tm.cap, tm.capacity, tm.effective_horizon()) == (
        jm.tree_depth, jm.cap, jm.capacity, jm.effective_horizon())
    np.testing.assert_array_equal(_np(tm.scales(device=CPU)), np.asarray(jm.scales()))
    np.testing.assert_array_equal(_np(tm.scales(clip_norm=0.3, device=CPU)),
                                  np.asarray(jm.scales(clip_norm=0.3)))
    for i, c in ((0, 3), (1, 20), (2, 2000)):
        assert tm.authorize_many(i, c) == jm.authorize_many(i, c)
    assert tm.authorize(0) == jm.authorize(0)
    _ledger_parity(tm.ledger(), jm.ledger())
    if tm.tree_depth:
        assert tm.ledger()[1]["tree"]["capacity"] == (1 << tm.tree_depth) - 1


@pytest.mark.parametrize("slack", [None, 0.5, 2.0, 3.5])
@pytest.mark.parametrize("horizon", [5, 64])
def test_per_owner_rounds_matches_reference(horizon, slack):
    jm = jfed.make_mechanism("per_owner_rounds", _owners(jfed),
                             jfed.FederationConfig(horizon=horizon), cap_slack=slack)
    tm = tfed.make_mechanism("per_owner_rounds", _owners(tfed),
                             tfed.FederationConfig(horizon=horizon), cap_slack=slack)
    assert tm.cap == jm.cap == tfed.capped_rounds(horizon, 3, 2.0 if slack is None else slack)
    np.testing.assert_array_equal(_np(tm.scales(device=CPU)), np.asarray(jm.scales()))
    for i in range(3):
        assert tm.authorize_many(i, 10 * i) == jm.authorize_many(i, 10 * i)
    _ledger_parity(tm.ledger(), jm.ledger())
    # the device ledger's caps come from the effective horizon
    np.testing.assert_array_equal(_np(tm.device_ledger(CPU).cap),
                                  np.asarray(jm.device_ledger().cap))


def test_accountant_views_match_reference():
    eps = {0: 1.0, 1: 0.25}
    for kw in (dict(), dict(composition="per_owner_rounds", cap_slack=1.5),
               dict(composition="tree", tree_depth=3), dict(composition="tree", tree_depth=0)):
        ja = jfed.PrivacyAccountant(eps, 40, n_owners=2, **kw)
        ta = tfed.PrivacyAccountant(eps, 40, n_owners=2, **kw)
        for owner, count in ((0, 5), (1, 2), (0, 100)):
            assert ta.record_responses(owner, count) == ja.record_responses(owner, count)
        assert ta.record_response(1) == ja.record_response(1)
        assert ta.summary() == ja.summary()
        for i in eps:
            assert ta.ledgers[i].effective_horizon == ja.ledgers[i].effective_horizon
            assert ta.ledgers[i].cap == ja.ledgers[i].cap
        np.testing.assert_array_equal(_np(ta.device_ledger(CPU).cap),
                                      np.asarray(ja.device_ledger().cap))


def _raises_like_reference(make_j, make_t):
    with pytest.raises(ValueError) as j_err:
        make_j()
    with pytest.raises(ValueError) as t_err:
        make_t()
    return str(j_err.value), str(t_err.value)


@pytest.mark.parametrize("case", [
    "tree_depth_on_paper", "tree_depth_on_per_owner_rounds", "cap_slack_on_tree",
    "cap_slack_on_paper", "negative_depth", "depth_31", "prebuilt_with_tree_depth",
    "prebuilt_with_cap_slack", "accountant_tree_without_depth",
    "accountant_depth_on_paper", "accountant_unknown_composition"])
def test_accounting_errors_match_reference(case):
    def build(mod):
        owners, cfg = _owners(mod, 2), mod.FederationConfig(horizon=10)
        calls = {
            "tree_depth_on_paper": lambda: mod.make_mechanism("paper", owners, cfg,
                                                              tree_depth=3),
            "tree_depth_on_per_owner_rounds": lambda: mod.make_mechanism(
                "per_owner_rounds", owners, cfg, tree_depth=3),
            "cap_slack_on_tree": lambda: mod.make_mechanism("tree", owners, cfg, cap_slack=2.0),
            "cap_slack_on_paper": lambda: mod.make_mechanism("paper", owners, cfg,
                                                             cap_slack=2.0),
            "negative_depth": lambda: mod.TreeMechanism(owners, cfg, depth=-1),
            "depth_31": lambda: mod.TreeMechanism(owners, cfg, depth=31),
            "prebuilt_with_tree_depth": lambda: mod.make_mechanism(
                mod.TreeMechanism(owners, cfg), owners, cfg, tree_depth=2),
            "prebuilt_with_cap_slack": lambda: mod.make_mechanism(
                mod.PaperMechanism(owners, cfg), owners, cfg, cap_slack=2.0),
            "accountant_tree_without_depth": lambda: mod.PrivacyAccountant(
                {0: 1.0}, 10, composition="tree"),
            "accountant_depth_on_paper": lambda: mod.PrivacyAccountant({0: 1.0}, 10,
                                                                       tree_depth=2),
            "accountant_unknown_composition": lambda: mod.PrivacyAccountant(
                {0: 1.0}, 10, composition="rdp"),
        }
        return calls[case]

    j_msg, t_msg = _raises_like_reference(build(jfed), build(tfed))
    assert t_msg == j_msg


def test_session_config_matches_reference():
    for kw in (dict(mechanism="tree", tree_depth=3), dict(mechanism="tree"),
               dict(mechanism="per_owner_rounds", cap_slack=1.0), dict()):
        jf = jfed.Federation(_owners(jfed), jfed.FederationConfig(horizon=30), **kw)
        tf = tfed.Federation(_owners(tfed), tfed.FederationConfig(horizon=30), device=CPU, **kw)
        jc, tc = jf.as_async_config(), tf.as_async_config()
        assert (tc.caps, tc.tree_depth, tc.effective_caps) == (jc.caps, jc.tree_depth,
                                                               jc.effective_caps)
        np.testing.assert_array_equal(_np(tfed.deep._noise_scales(tc, CPU)),
                                      np.asarray(jdeep._noise_scales(jc)))
        np.testing.assert_array_equal(_np(tf.mechanism.scales(device=CPU)),
                                      np.asarray(jf.mechanism.scales()))


# ------------------------------ the engine's guards -------------------------------
def _toy_params():
    return {"w": torch.linspace(-1.0, 1.0, 6), "b": torch.zeros(())}


def _toy_loss(p, b):
    return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _toy_batches(k, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(k, 4, 6, generator=gen), "y": torch.randn(k, 4, generator=gen)}


def _priv():
    return tfed.PrivatizerConfig(xi=1.0, granularity="microbatch", n_microbatches=2,
                                 fused_kernel=True)


def test_engine_guards():
    base = tfed.AsyncDPConfig(n_owners=2, horizon=100, epsilons=(1.0, 1.0), owner_sizes=(50, 50),
                              privatizer=_priv(), tree_depth=3)
    with pytest.raises(ValueError, match="holds 7 leaves"):
        tfed.make_train_step(_toy_loss, base, device=CPU)     # caps default to T = 100 > 7
    with pytest.raises(ValueError, match=r"\[0, 30\]"):
        tfed.make_fused_rounds(_toy_loss, dataclasses.replace(base, tree_depth=31), device=CPU)
    ok = dataclasses.replace(base, caps=(7, 7))
    step = tfed.make_train_step(_toy_loss, ok, device=CPU)
    batch = {k: v[0] for k, v in _toy_batches(1).items()}
    bare = tfed.init_state_flat(_toy_params(), dataclasses.replace(ok, tree_depth=None), CPU)
    with pytest.raises(ValueError, match="no noise tree"):
        step(bare, batch, torch.tensor(0), trandom.PRNGKey(0, device=CPU))
    other = tfed.init_state_flat(_toy_params(), dataclasses.replace(ok, tree_depth=2), CPU)
    with pytest.raises(ValueError, match="depth 2"):
        step(other, batch, torch.tensor(0), trandom.PRNGKey(0, device=CPU))


def test_init_tree_noise_shapes():
    cfg = tfed.AsyncDPConfig(n_owners=3, horizon=7, epsilons=(1.0,) * 3, owner_sizes=(10,) * 3,
                             privatizer=_priv(), tree_depth=3)
    state = tfed.init_state_flat(_toy_params(), cfg, CPU)
    tr = state.tree
    assert tr.nodes.shape == (3, 3, 7) and tr.nodes.dtype == torch.float32
    assert tr.counts.shape == (3,) and tr.counts.dtype == torch.int32 and tr.depth == 3
    assert not bool(tr.nodes.any()) and not bool(tr.counts.any())
    np.testing.assert_array_equal(_np(state.ledger.cap), [7, 7, 7])
    assert tfed.init_tree_noise(dataclasses.replace(cfg, tree_depth=None), state.theta_L) is None
    again = tree_noise_from_numpy(np.ones((3, 3, 7), np.float32), np.arange(3), 3, device=CPU)
    assert again.counts.dtype == torch.int32 and bool((again.nodes == 1).all())
    with pytest.raises(ValueError, match="depth-2"):
        tree_noise_from_numpy(np.ones((3, 3, 7), np.float32), np.arange(3), 2, device=CPU)


# ------------------------- the session against the reference -----------------------
N_LM, G_LM, B_LM, S_LM = 4, 2, 4, 16


@pytest.fixture(scope="module")
def lm_case():
    jlm = jax_build_model(JAX_REDUCED, remat=False)
    jparams = jlm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, JAX_REDUCED.vocab, size=(12, B_LM, S_LM),
                                             dtype=np.int32)
    return jlm, jparams, {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}


def _lm_sessions(lm_case, depth, horizon, spent=()):
    """Both packages' sessions under the tree mechanism, each owner's
    responses first charged `spent[i]` times on the host."""
    jlm, jparams, _ = lm_case
    lm = LM(DENSE_124M.reduced())
    out = []
    for mod, loss, kw in ((jfed, lambda p, b: jlm.loss(p, b)[0], {}),
                          (tfed, lambda p, b: lm.loss(p, b)[0], dict(device=CPU))):
        owners = [mod.DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0) for i in range(N_LM)]
        fed = mod.Federation(owners, mod.FederationConfig.from_target_lr(
            0.05, n_owners=N_LM, horizon=horizon, sigma=1e-2, theta_max=100.0),
            mechanism="tree", tree_depth=depth, **kw)
        fed.make_step(loss, pack_params=True, privatizer=mod.PrivatizerConfig(
            xi=1.0, granularity="microbatch", n_microbatches=G_LM, fused_kernel=True))
        for i, c in enumerate(spent):
            assert fed.mechanism.authorize_many(i, int(c)) == c
        params = (jparams if mod is jfed else
                  params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU))
        out.append((fed, fed.init_state(params)))
    return out


def _run_both(lm_case, sessions, k, seed):
    _, _, data = lm_case
    (jf, js), (tf, ts) = sessions
    js, jm = jf.run_rounds(js, {n: jnp.asarray(v[:k]) for n, v in data.items()},
                           key=jax.random.PRNGKey(seed))
    ts, tm = tf.run_rounds(ts, {n: torch.from_numpy(v[:k]) for n, v in data.items()},
                           key=trandom.PRNGKey(seed, device=CPU))
    np.testing.assert_array_equal(_np(tm["owner"]), np.asarray(jm["owner"]))
    refused = _np(tm["refused"])
    np.testing.assert_array_equal(refused, np.asarray(jm["refused"]))
    _ledger_parity(tf.reconcile(ts), jf.reconcile(js))
    np.testing.assert_array_equal(_np(ts.tree.counts), np.asarray(js.tree.counts))
    np.testing.assert_array_equal(_np(ts.ledger.spent), np.asarray(js.ledger.spent))
    np.testing.assert_allclose(_np(ts.theta_L.buf), np.asarray(js.theta_L.buf),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(ts.bank), np.asarray(js.bank), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(ts.tree.nodes), np.asarray(js.tree.nodes),
                               rtol=RTOL, atol=ATOL)
    return refused, ts, tf


def test_reduced_lm_tree_session_matches_reference(lm_case):
    # depth 2: capacity 3 under a horizon of 8, so owners hit the cap
    refused, ts, tf = _run_both(lm_case, _lm_sessions(lm_case, depth=2, horizon=8), 12, 5)
    assert refused.any() and not refused.all()                  # refusal really bites
    led = tf.ledger()
    assert all(row["tree"]["capacity"] == 3 for row in led.values())
    assert bool(ts.tree.nodes.ne(0).any())


def test_reduced_lm_tree_session_from_a_mid_run_tree(lm_case):
    # depth 3 (capacity 7) started mid-run: the counts 3, 5, 6, 1 put the
    # next leaf at every retire pattern (r = 2, 1, 0, 1), and owner 2 runs
    # into its cap
    counts = np.array([3, 5, 6, 1], np.int32)
    rng = np.random.default_rng(1)
    sessions = _lm_sessions(lm_case, depth=3, horizon=8, spent=counts)
    p = sessions[1][1].theta_L.size
    active = (counts[:, None] >> np.arange(3)[None, :]) & 1
    nodes = (rng.standard_normal((N_LM, 3, p)) * 0.05 * active[..., None]).astype(np.float32)
    (jf, js), (tf, ts) = sessions
    js = js._replace(tree=jdeep.TreeNoise(jnp.asarray(nodes), jnp.asarray(counts), 3))
    ts = ts._replace(tree=tree_noise_from_numpy(nodes, counts, 3, device=CPU))
    refused, ts, _ = _run_both(lm_case, [(jf, js), (tf, ts)], 10, 8)
    assert refused.any()


# ----------------------------- contracts inside the port ----------------------------
def _toy_fed(mechanism="tree", depth=2, horizon=16, bank_dtype=None):
    kw = dict(tree_depth=depth) if mechanism == "tree" else {}
    fed = tfed.Federation([tfed.DataOwner(n=200, epsilon=2.0, xi=1.0)] * 3,
                          tfed.FederationConfig(horizon=horizon, sigma=1e-2, theta_max=10.0,
                                                lr_scale=5.0),
                          mechanism=mechanism, device=CPU, **kw)
    fed.make_step(_toy_loss, privatizer=_priv(), pack_params=True, bank_dtype=bank_dtype)
    return fed


def test_depth0_tree_equals_paper_bit_for_bit():
    batches = _toy_batches(12)
    owner_seq = [0, 1, 2, 2, 1, 0, 0, 0, 1, 2, 2, 2]
    out = []
    for mech in ("tree", "paper"):
        fed = _toy_fed(mech, depth=0)
        state, ms = fed.run_rounds(fed.init_state(_toy_params()), batches, owner_seq,
                                   key=trandom.PRNGKey(3, device=CPU))
        state, _ = fed.step(state, {k: v[0] for k, v in batches.items()}, 1,
                            trandom.PRNGKey(4, device=CPU))
        out.append((state, _np(ms["refused"]), fed.reconcile(state)))
    (t_state, t_ref, t_led), (p_state, p_ref, p_led) = out
    assert torch.equal(t_state.theta_L.buf, p_state.theta_L.buf)
    assert torch.equal(t_state.bank, p_state.bank)
    np.testing.assert_array_equal(t_ref, p_ref)
    assert t_led == p_led
    assert t_state.tree.nodes.shape == (3, 0, 7)
    # the degenerate tree still counts every granted leaf
    assert _np(t_state.tree.counts).tolist() == [4, 4, 5]


def _tree_snapshot(s):
    bank = s.bank
    parts = (bank.codes, bank.scales, bank.residual) if isinstance(bank, QuantBank) else (bank,)
    return [t.clone() for t in (s.theta_L.buf, *parts, s.tree.nodes, s.tree.counts)]


def test_step_loop_equals_run_rounds_bit_for_bit():
    # depth 2: capacity 3 < 8 rounds per owner, so refusals hit mid-schedule
    batches = _toy_batches(24, seed=1)
    owner_seq = [k % 3 for k in range(24)]
    root = trandom.PRNGKey(9, device=CPU)
    loop = _toy_fed()
    s_loop = loop.init_state(_toy_params())
    refused_loop = []
    for k, key in enumerate(trandom.split(root, 24)):
        s_loop, m = loop.step(s_loop, {n: v[k] for n, v in batches.items()}, owner_seq[k], key)
        refused_loop.append(m["refused"])
    fused = _toy_fed()
    s_fused, ms = fused.run_rounds(fused.init_state(_toy_params()), batches, owner_seq,
                                   key=root)
    assert refused_loop == _np(ms["refused"]).tolist() and sum(refused_loop) == 15
    assert all(torch.equal(a, b) for a, b in zip(_tree_snapshot(s_loop),
                                                 _tree_snapshot(s_fused)))
    assert _np(s_fused.tree.counts).tolist() == [3, 3, 3]
    assert fused.reconcile(s_fused) == loop.ledger()


@pytest.mark.parametrize("bank_dtype", [None, torch.bfloat16, "int8", "fp8"])
def test_refused_round_is_bit_exact_no_op(bank_dtype):
    fed = _toy_fed(depth=1, horizon=16, bank_dtype=bank_dtype)          # capacity 1
    state = fed.init_state(_toy_params())
    one = {k: v[:1] for k, v in _toy_batches(1).items()}
    state, m = fed.run_rounds(state, one, [1], key=trandom.PRNGKey(1, device=CPU))
    assert not bool(m["refused"][0]) and bool(state.tree.nodes[1].ne(0).any())
    before = _tree_snapshot(state)
    state, m = fed.run_rounds(state, one, [1], key=trandom.PRNGKey(2, device=CPU))
    assert bool(m["refused"][0])
    assert all(torch.equal(a, b) for a, b in zip(_tree_snapshot(state), before))
    led = fed.reconcile(state)
    assert (led[1]["responses"], led[1]["refused"]) == (1, 1)
    assert led[1]["tree"]["nodes_completed_per_level"] == [1]
