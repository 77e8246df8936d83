"""The port's pytree engine: its contracts inside the port, the toy
sessions against the reference, and the reference's errors, on the CPU.

Inside the port, bit for bit on f32: `spec.pack` of the pytree path's
state equals the flat engine's reference mode (fused_kernel=False) under
the same keys, with the tree mechanism too (nodes and counts), on a toy
model and on the reduced dense LM; the step loop equals `run_rounds`; a
refused round leaves every leaf, node and count unchanged. Against the
reference, the toy sessions in the fused, unfused and tree forms: owners,
refusals, ledgers and counts exact, theta_L, the bank and the nodes within
rtol 1e-4 and atol 1e-6 as in test_torch_pytree_session.py.
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federation as jfed
import repro_torch.federation as tfed
from repro_torch import random as trandom
from repro_torch.configs.base import DENSE_124M
from repro_torch.convert import pytree_state_from_numpy, tree_noise_from_numpy
from repro_torch.federation import ParamFlat
from repro_torch.models import LM
from repro_torch.tree_util import tree_flatten

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-6

@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ledger_parity(led_torch, led_jax):
    assert set(led_torch) == set(led_jax)
    for i, row in led_torch.items():
        jrow = led_jax[i]
        assert row == {k: jrow[k] for k in row}, i
        assert all(jrow[k] == 0 for k in set(jrow) - set(row)), i


def _assert_trees_close(t_tree, j_tree):
    t_leaves = tree_flatten(t_tree)[0]
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    assert len(t_leaves) == len(j_leaves) > 0
    for t, j in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


# --------------------------------- the toy model ----------------------------------
def _toy_params():
    return {"w": np.linspace(-1.0, 1.0, 6).astype(np.float32), "b": np.float32(0.0)}


def _toy_batches(k, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((k, 4, 6)).astype(np.float32),
            "y": rng.standard_normal((k, 4)).astype(np.float32)}


def _jax_toy_loss(p, b):
    return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _torch_toy_loss(p, b):
    return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


TOY_FORMS = {"unfused": (False, None), "fused": (True, None), "tree": (False, 2)}


def _toy_fed(mod, form, horizon=16, pack_params=False, **kw):
    fused, depth = TOY_FORMS[form]
    mech = {} if depth is None else dict(mechanism="tree", tree_depth=depth)
    fed = mod.Federation([mod.DataOwner(n=200, epsilon=2.0, xi=1.0)] * 3,
                         mod.FederationConfig(horizon=horizon, sigma=1e-2, theta_max=10.0,
                                              lr_scale=5.0), **mech, **kw)
    loss = _torch_toy_loss if mod is tfed else _jax_toy_loss
    fed.make_step(loss, pack_params=pack_params, privatizer=mod.PrivatizerConfig(
        xi=1.0, n_microbatches=2, fused_kernel=fused))
    return fed


def _port_toy_fed(form, horizon=16, pack_params=False):
    return _toy_fed(tfed, form, horizon, pack_params, device=CPU)


OWNERS = [0, 1, 2, 2, 1, 0, 0, 0, 1, 2, 2, 2]


@pytest.mark.parametrize("form", sorted(TOY_FORMS))
def test_toy_pytree_session_matches_reference(form):
    # horizon 4 (paper) or capacity 3 (tree) over 5 rounds of owner 0 or 2
    horizon = 4 if form != "tree" else 16
    batches = _toy_batches(12)
    jf, tf = _toy_fed(jfed, form, horizon), _port_toy_fed(form, horizon)
    js, jm = jf.run_rounds(jf.init_state(jax.tree_util.tree_map(jnp.asarray, _toy_params())),
                           {k: jnp.asarray(v) for k, v in batches.items()}, OWNERS,
                           key=jax.random.PRNGKey(3))
    ts, tm = tf.run_rounds(tf.init_state(_torch_tree(_toy_params())), _torch_tree(batches),
                           OWNERS, key=trandom.PRNGKey(3, device=CPU))
    np.testing.assert_array_equal(tm["refused"].numpy(), np.asarray(jm["refused"]))
    assert bool(tm["refused"].any())
    _ledger_parity(tf.reconcile(ts), jf.reconcile(js))
    _assert_trees_close(ts.theta_L, js.theta_L)
    _assert_trees_close(ts.bank, js.bank)
    if form == "tree":
        np.testing.assert_array_equal(ts.tree.counts.numpy(), np.asarray(js.tree.counts))
        _assert_trees_close(ts.tree.nodes, js.tree.nodes)


# --------------------------- contracts inside the port ----------------------------
def _flat_of(spec, tree, lead=0):
    """A pytree state's leaves packed like the flat engine's: `lead`
    leading axes (owners, levels) kept."""
    leaves = tree_flatten(tree)[0]
    head = leaves[0].shape[:lead]
    return torch.cat([leaf.reshape(head + (-1,)) for leaf in leaves], dim=lead)


@pytest.mark.parametrize("form", ["unfused", "tree"])
def test_pack_of_pytree_equals_flat_reference_mode_bit_for_bit(form):
    # owners 0 and 2 run past horizon 4 / capacity 3; owner 1 keeps room
    # for the host-authorized step after the reconcile
    owners = [0, 2, 2, 0, 0, 0, 2, 2, 1, 2]
    batches = _toy_batches(10, seed=4)
    root = trandom.PRNGKey(6, device=CPU)
    out = []
    for pack in (False, True):
        fed = _port_toy_fed(form, horizon=4 if form == "unfused" else 16, pack_params=pack)
        state = fed.init_state(_torch_tree(_toy_params()))
        assert isinstance(state.theta_L, ParamFlat) == pack
        state, ms = fed.run_rounds(state, _torch_tree(batches), owners, key=root)
        fed.reconcile(state)
        state, m = fed.step(state, {k: v[0] for k, v in _torch_tree(batches).items()}, 1,
                            trandom.PRNGKey(7, device=CPU))
        out.append((state, ms, m, fed.ledger()))
    (p_state, p_ms, p_m, p_led), (f_state, f_ms, f_m, f_led) = out
    spec = f_state.theta_L.spec
    assert torch.equal(spec.pack(p_state.theta_L), f_state.theta_L.buf)
    assert torch.equal(_flat_of(spec, p_state.bank, 1), f_state.bank)
    assert p_led == f_led and torch.equal(p_ms["refused"], f_ms["refused"])
    assert bool(p_ms["refused"].any()) and not p_m["refused"] and not f_m["refused"]
    for name in ("clip_frac", "max_grad_norm", "grad_noise_scale"):
        assert torch.equal(p_ms[name], f_ms[name]) and torch.equal(p_m[name], f_m[name])
    if form == "tree":
        assert torch.equal(_flat_of(spec, p_state.tree.nodes, 2), f_state.tree.nodes)
        assert torch.equal(p_state.tree.counts, f_state.tree.counts)


def test_pack_of_pytree_equals_flat_reference_mode_on_the_reduced_lm():
    # the dense LM's 12 leaves (stacked layers, NamedTuples) under the tree
    # at depth 2, capacity 3: 10 rounds of 3 owners, refusals included
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=3, device=CPU)
    toks = torch.randint(0, cfg.vocab, (10, 4, 8), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    out = []
    for pack in (False, True):
        fed = tfed.Federation([tfed.DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0)
                               for i in range(3)],
                              tfed.FederationConfig.from_target_lr(0.05, n_owners=3, horizon=8,
                                                                   sigma=1e-2),
                              mechanism="tree", tree_depth=2, device=CPU)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=pack,
                      privatizer=tfed.PrivatizerConfig(xi=1.0, n_microbatches=2))
        state, ms = fed.run_rounds(fed.init_state(params), batches,
                                   key=trandom.PRNGKey(11, device=CPU))
        out.append((state, ms["refused"], fed.reconcile(state)))
    (p_state, p_ref, p_led), (f_state, f_ref, f_led) = out
    spec = f_state.theta_L.spec
    assert bool(p_ref.any()) and torch.equal(p_ref, f_ref) and p_led == f_led
    assert torch.equal(spec.pack(p_state.theta_L), f_state.theta_L.buf)
    assert torch.equal(_flat_of(spec, p_state.bank, 1), f_state.bank)
    assert torch.equal(_flat_of(spec, p_state.tree.nodes, 2), f_state.tree.nodes)
    assert torch.equal(p_state.tree.counts, f_state.tree.counts)


def _snapshot(state):
    parts = [state.theta_L, state.bank] + ([] if state.tree is None
                                           else [state.tree.nodes, state.tree.counts])
    return [t.clone() for part in parts for t in tree_flatten(part)[0]]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("form", sorted(TOY_FORMS))
def test_step_loop_equals_run_rounds_bit_for_bit(form):
    # horizon 4 / capacity 3 < 8 rounds per owner: refusals mid-schedule
    horizon = 4 if form != "tree" else 16
    batches = _torch_tree(_toy_batches(24, seed=1))
    owner_seq = [k % 3 for k in range(24)]
    root = trandom.PRNGKey(9, device=CPU)
    loop = _port_toy_fed(form, horizon)
    s_loop = loop.init_state(_torch_tree(_toy_params()))
    refused_loop = []
    for k, key in enumerate(trandom.split(root, 24)):
        s_loop, m = loop.step(s_loop, {n: v[k] for n, v in batches.items()}, owner_seq[k], key)
        refused_loop.append(m["refused"])
    fused = _port_toy_fed(form, horizon)
    s_fused, ms = fused.run_rounds(fused.init_state(_torch_tree(_toy_params())), batches,
                                   owner_seq, key=root)
    assert refused_loop == ms["refused"].tolist() and any(refused_loop)
    assert _same(_snapshot(s_loop), _snapshot(s_fused))
    assert int(s_loop.step) == int(s_fused.step) == refused_loop.count(False)
    assert fused.reconcile(s_fused) == loop.ledger()


@pytest.mark.parametrize("form", sorted(TOY_FORMS))
def test_refused_round_is_bit_exact_no_op(form):
    fed = _port_toy_fed(form, horizon=1 if form != "tree" else 16)
    if form == "tree":
        fed.mechanism.authorize_many(1, 2)              # capacity 3: one leaf left
    state = fed.init_state(_torch_tree(_toy_params()))
    one = {k: v[:1] for k, v in _torch_tree(_toy_batches(1)).items()}
    state, m = fed.run_rounds(state, one, [1], key=trandom.PRNGKey(1, device=CPU))
    assert not bool(m["refused"][0])
    before = _snapshot(state)
    state, m = fed.run_rounds(state, one, [1], key=trandom.PRNGKey(2, device=CPU))
    assert bool(m["refused"][0])
    assert _same(_snapshot(state), before)
    led = fed.reconcile(state)
    assert led[1]["refused"] == 1


@pytest.mark.parametrize("pack_params", [False, True])
@pytest.mark.parametrize("form", ["fused", "tree"])
def test_rounds_leave_no_reference_cycles(form, pack_params):
    # a cycle that holds a tree's leaf list keeps a round's tensors alive
    # until Python's cycle collector runs: on the card, gigabytes of a
    # round's transients per dispatch
    fed = _port_toy_fed(form, pack_params=pack_params)
    state = fed.init_state(_torch_tree(_toy_params()))
    batches = _torch_tree(_toy_batches(3))
    gc.collect()
    gc.disable()
    try:
        state, _ = fed.run_rounds(state, batches, [0, 1, 0], key=trandom.PRNGKey(2, device=CPU))
        state, _ = fed.step(state, {k: v[0] for k, v in batches.items()}, 2,
                            trandom.PRNGKey(3, device=CPU))
        assert gc.collect() == 0
    finally:
        gc.enable()


def test_init_state_materializes_the_bank_and_the_nodes():
    fed = _port_toy_fed("tree")
    params = _torch_tree(_toy_params())
    state = fed.init_state(params)
    for leaf, bank, nodes in zip(tree_flatten(state.theta_L)[0], tree_flatten(state.bank)[0],
                                 tree_flatten(state.tree.nodes)[0]):
        assert bank.shape == (3,) + leaf.shape and bank.is_contiguous()
        assert 0 not in bank.stride()                 # not a broadcast view
        assert torch.equal(bank, leaf.expand_as(bank))
        assert nodes.shape == (3, 2) + leaf.shape and nodes.dtype == torch.float32
    # theta_L is the state's own copy, not the caller's tensors
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(tree_flatten(state.theta_L)[0], tree_flatten(params)[0]))
    assert tfed.init_tree_noise(dataclasses.replace(fed.as_async_config(), tree_depth=None),
                                state.theta_L) is None


def test_params_of_returns_the_tree_for_either_state_kind():
    for pack in (False, True):
        fed = _port_toy_fed("unfused", pack_params=pack)
        state = fed.init_state(_torch_tree(_toy_params()))
        tree = fed.params_of(state)
        assert sorted(tree) == ["b", "w"]
        assert torch.equal(tree["w"], torch.from_numpy(_toy_params()["w"]))


# -------------------------------- the reference's errors ---------------------------
def _error_pair(make_j, make_t):
    msgs = []
    for make in (make_j, make_t):
        with pytest.raises(ValueError) as err:
            make()
        msgs.append(str(err.value))
    return msgs


def test_tree_with_fused_kernel_on_a_pytree_state_raises_like_reference():
    def run(mod):
        fed = _toy_fed(mod, "tree", **({} if mod is jfed else dict(device=CPU)))
        priv = mod.PrivatizerConfig(xi=1.0, n_microbatches=2, fused_kernel=True)
        loss = _jax_toy_loss if mod is jfed else _torch_toy_loss
        fed.make_step(loss, privatizer=priv)
        conv = (lambda t: jax.tree_util.tree_map(jnp.asarray, t)) if mod is jfed else _torch_tree
        key = jax.random.PRNGKey(0) if mod is jfed else trandom.PRNGKey(0, device=CPU)
        batch = {k: v[0] for k, v in conv(_toy_batches(1)).items()}
        return lambda: fed.step(fed.init_state(conv(_toy_params())), batch, 0, key)

    j_msg, t_msg = _error_pair(run(jfed), run(tfed))
    assert t_msg == j_msg and "fused_kernel needs the flat engine" in t_msg


def test_bank_dtype_on_a_pytree_state_raises_like_reference():
    def run(mod):
        fed = _toy_fed(mod, "unfused", **({} if mod is jfed else dict(device=CPU)))
        conv = (lambda t: jax.tree_util.tree_map(jnp.asarray, t)) if mod is jfed else _torch_tree
        return lambda: fed.init_state(conv(_toy_params()), bank_dtype="int8")

    j_msg, t_msg = _error_pair(run(jfed), run(tfed))
    assert t_msg == j_msg
    # make_step's bank_dtype does not apply to a pytree state: no error
    fed = _port_toy_fed("unfused")
    fed.make_step(_torch_toy_loss, bank_dtype="int8")
    assert not isinstance(fed.init_state(_torch_tree(_toy_params())).theta_L, ParamFlat)


def test_convert_refuses_mismatched_pytree_states():
    theta = {"w": np.zeros(6, np.float32)}
    with pytest.raises(ValueError, match="rows of"):
        pytree_state_from_numpy(theta, {"w": np.zeros((3, 5), np.float32)}, device=CPU)
    with pytest.raises(ValueError, match="depth-2"):
        tree_noise_from_numpy({"w": np.zeros((3, 3, 6), np.float32)}, np.zeros(3), 2,
                              device=CPU)
