"""The port's owner-parallel grouped driver (`run_rounds(owner_parallel=True)`)
held against the JAX reference on the CPU.

Both packages run the same seeded numpy inputs (weights carried across by
`repro_torch.convert`, batches, owner sequences and keys) through
`Federation.run_rounds(..., owner_parallel=True)` on six states: the flat
f32 bank with the fused privatizer and in reference mode
(fused_kernel=False), the int8 and fp8 banks, the tree mechanism at depth
2 (flat, fused) and the pytree state (fused privatizer). The reference
runs its kernels' jnp oracles under vmap; the port runs its plain versions
on CPU tensors (on CUDA, one batched launch per group).

Exact across packages: the conflict-free partition, the group cap of
max_group="auto", owner sequences, refusal masks, the device ledger, the
step counter and the reconciled ledger. Within tolerance: theta_L, the
bank and the nodes (rtol 1e-4, atol 1e-6, the flat engine's parity
tolerance: two autodiff systems, and log1p may differ by an ulp); on the
quantized banks codes within one grid step, as in test_torch_quant_bank.

Inside the port, bit for bit: max_group=1 equals the sequential driver
(run_rounds routes to it), the tree's nodes and counts equal the
sequential driver's (the noise does not depend on theta), and each batched
plain version (dp_round_rows, fused_sqnorm_rows, tree_delta_rows_) equals
its single-row entry point called row by row.

The reference's `test_owner_parallel_repeat_dispatches_reuse_compile_cache`
has no counterpart: torch compiles nothing, so the port runs each group at
its own length and pads nothing. Its bf16-bank case is here
(test_bf16_bank_under_grouped_owner_parallel); its mesh cases are in
tests/test_torch_sharded_engine.py.
"""
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
from repro_torch.federation import QuantBank
from repro_torch.kernels.dp_clip_noise import ops as dops
from repro_torch.kernels.tree_noise import ops as tops
from repro_torch.models import LM
from repro_torch.tree_util import tree_flatten

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-6
N, K = 8, 24

# state: (make_step kwargs, Federation kwargs); horizon 3 (paper) and tree
# capacity 3 over 24 rounds of 8 owners make exhaustion bite
STATES = {
    "f32": (dict(pack_params=True), {}),
    "f32-unfused": (dict(pack_params=True, fused=False), {}),
    "int8": (dict(pack_params=True, bank_dtype="int8"), {}),
    "fp8": (dict(pack_params=True, bank_dtype="fp8"), {}),
    "tree": (dict(pack_params=True), dict(mechanism="tree", tree_depth=2)),
    "pytree": (dict(pack_params=False), {}),
}
# the tree states of the nodes contract: the flat fused engine (batched
# tree_delta), and the reference mode and the pytree state (members one
# after another through the round, the noise drawn by the privatizer)
TREE_STATES = {
    "tree": STATES["tree"],
    "tree-unfused": (dict(pack_params=True, fused=False), dict(mechanism="tree", tree_depth=2)),
    "tree-pytree": (dict(pack_params=False, fused=False), dict(mechanism="tree", tree_depth=2)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((6, 4)).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    data = {"x": rng.standard_normal((K, 4, 6)).astype(np.float32),
            "y": rng.standard_normal((K, 4, 4)).astype(np.float32)}
    seq = np.array(jax.random.randint(jax.random.PRNGKey(3), (K,), 0, N))
    return params, data, seq


def _fed(mod, state, horizon=3, **extra):
    step_kw, fed_kw = STATES.get(state) or TREE_STATES[state]
    step_kw = dict(step_kw)
    priv = mod.PrivatizerConfig(xi=1.0, granularity="microbatch", n_microbatches=2,
                                fused_kernel=step_kw.pop("fused", True))
    fed = mod.Federation([mod.DataOwner(n=100 * (1 + i % 3), epsilon=1.0, xi=1.0)
                          for i in range(N)],
                         mod.FederationConfig(horizon=horizon, sigma=1e-2, theta_max=10.0,
                                              lr_scale=5.0), **fed_kw, **extra)
    if mod is jfed:
        def loss(p, b):
            return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
    else:
        def loss(p, b):
            return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
    fed.make_step(loss, privatizer=priv, **step_kw)
    return fed


def _run_torch(toy, state, seq=None, horizon=3, key=4, **kw):
    params, data, toy_seq = toy
    fed = _fed(tfed, state, horizon=horizon, device=CPU)
    st = fed.init_state(params_from_numpy(params, device=CPU))
    st, ms = fed.run_rounds(st, {k: torch.from_numpy(v) for k, v in data.items()},
                            toy_seq if seq is None else seq,
                            key=trandom.PRNGKey(key, device=CPU), **kw)
    return fed, st, ms


def _run_jax(toy, state, **kw):
    params, data, seq = toy
    fed = _fed(jfed, state)
    st = fed.init_state({k: jnp.asarray(v) for k, v in params.items()})
    st, ms = fed.run_rounds(st, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(seq),
                            key=jax.random.PRNGKey(4), **kw)
    return fed, st, ms


def _ledger_parity(led_torch, led_jax):
    """The port's ledger equals the reference's on every key it has; the
    reference's fault and staleness columns are all zero here."""
    assert set(led_torch) == set(led_jax)
    for i, row in led_torch.items():
        jrow = led_jax[i]
        assert row == {k: jrow[k] for k in row}, i
        assert all(jrow[k] == 0 for k in set(jrow) - set(row)), i


def _theta_leaves(st):
    theta = st.theta_L
    return [theta.buf] if isinstance(theta, tfed.ParamFlat) else tree_flatten(theta)[0]


def _state_tensors(st):
    """Every tensor of a port state (theta_L, bank, ledger, step, tree)."""
    bank = st.bank
    out = _theta_leaves(st)
    out += ([bank.codes, bank.scales, bank.residual] if isinstance(bank, QuantBank)
            else tree_flatten(bank)[0])
    out += [st.ledger.spent, st.ledger.refused, st.step]
    if st.tree is not None:
        out += tree_flatten(st.tree.nodes)[0] + [st.tree.counts]
    return out


# --------------------------- the schedule analysis ---------------------------------
SEQUENCES = {
    "empty": np.zeros(0, np.int32),
    "single owner": np.zeros(9, np.int32),
    "all distinct": np.arange(12, dtype=np.int32),
    "two owners alternating": np.arange(10, dtype=np.int32) % 2,
    **{f"uniform N={n} seed={s}": np.asarray(jax.random.randint(
        jax.random.PRNGKey(s), (64,), 0, n)) for n, s in ((4, 0), (16, 1), (64, 2), (200, 3))},
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_schedule_analysis_equals_reference(name):
    seq = SEQUENCES[name]
    for cap in (None, 1, 2, 3, 5, 8, 16):
        groups = tfed.partition_conflict_free(seq, cap)
        assert groups == jfed.partition_conflict_free(seq, cap), cap
        for t, j in zip(tfed.pack_groups(groups), jfed.pack_groups(groups)):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
    for overhead, cap in ((4.0, 16), (1.0, 16), (4.0, 4), (0.5, 3)):
        assert (tfed.auto_max_group(seq, overhead, cap)
                == jfed.auto_max_group(seq, overhead, cap)), (overhead, cap)
    for mod in (tfed, jfed):
        with pytest.raises(ValueError, match="max_group must be >= 1"):
            mod.partition_conflict_free(seq, 0)


# ------------------------ the grouped driver against the reference -----------------
@pytest.mark.parametrize("state", list(STATES))
def test_grouped_run_rounds_matches_reference(toy, state):
    jf, js, jm = _run_jax(toy, state, owner_parallel=True)
    tf, ts, tm = _run_torch(toy, state, owner_parallel=True)
    groups = tfed.partition_conflict_free(toy[2], tfed.auto_max_group(toy[2]))
    assert max(n for _, n in groups) > 1                     # real groups ran
    for name in ("owner", "refused"):
        np.testing.assert_array_equal(_np(tm[name]), np.asarray(jm[name]))
    assert _np(tm["refused"]).any()                          # exhaustion bites
    np.testing.assert_array_equal(_np(ts.ledger.spent), np.asarray(js.ledger.spent))
    np.testing.assert_array_equal(_np(ts.ledger.refused), np.asarray(js.ledger.refused))
    assert int(ts.step) == int(js.step)
    _ledger_parity(tf.reconcile(ts), jf.reconcile(js))
    for name in ("clip_frac", "max_grad_norm", "grad_noise_scale"):
        np.testing.assert_allclose(_np(tm[name]), np.asarray(jm[name]), rtol=RTOL, atol=ATOL)
    j_theta = ([js.theta_L.buf] if isinstance(js.theta_L, jfed.ParamFlat)
               else jax.tree_util.tree_leaves(js.theta_L))
    for t, j in zip(_theta_leaves(ts), j_theta, strict=True):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=RTOL, atol=ATOL)
    if isinstance(ts.bank, QuantBank):
        # a last-ulp difference may flip a stochastic rounding decision: the
        # codes then differ by one grid step and the residual by a step
        step = float(np.asarray(js.bank.scales).max()) * (1.0 if state == "int8" else 32.0)
        dcode = np.abs(_np(ts.bank.codes).astype(np.int32)
                       - np.asarray(js.bank.codes).astype(np.int32))
        assert dcode.max() <= 1 and (dcode > 0).sum() <= 1
        np.testing.assert_allclose(_np(ts.bank.scales), np.asarray(js.bank.scales),
                                   rtol=1e-6, atol=0)
        assert np.abs(_np(ts.bank.residual) - np.asarray(js.bank.residual)).max() <= step
    else:
        for t, j in zip(tree_flatten(ts.bank)[0], jax.tree_util.tree_leaves(js.bank),
                        strict=True):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=RTOL, atol=ATOL)
    if ts.tree is not None:
        np.testing.assert_array_equal(_np(ts.tree.counts), np.asarray(js.tree.counts))
        np.testing.assert_allclose(_np(ts.tree.nodes), np.asarray(js.tree.nodes),
                                   rtol=RTOL, atol=ATOL)


# ------------------------------ contracts inside the port --------------------------
@pytest.mark.parametrize("state", list(STATES))
def test_max_group_one_is_the_sequential_driver_bit_for_bit(toy, state):
    _, s_seq, m_seq = _run_torch(toy, state)
    _, s_grp, m_grp = _run_torch(toy, state, owner_parallel=True, max_group=1)
    for a, b in zip(_state_tensors(s_seq), _state_tensors(s_grp), strict=True):
        assert torch.equal(a, b)
    assert set(m_seq) == set(m_grp)
    for name in m_seq:
        assert torch.equal(m_seq[name], m_grp[name]), name


@pytest.mark.parametrize("state", list(TREE_STATES))
def test_tree_nodes_and_counts_equal_the_sequential_driver_bit_for_bit(toy, state):
    # the nodes hold the Laplace draws, which depend on the keys and the
    # counts only, never on theta: grouping leaves them exact
    _, s_seq, m_seq = _run_torch(toy, state)
    _, s_grp, m_grp = _run_torch(toy, state, owner_parallel=True, max_group=None)
    assert torch.equal(m_seq["refused"], m_grp["refused"]) and bool(m_grp["refused"].any())
    assert torch.equal(s_seq.tree.counts, s_grp.tree.counts)
    for a, b in zip(tree_flatten(s_seq.tree.nodes)[0], tree_flatten(s_grp.tree.nodes)[0],
                    strict=True):
        assert torch.equal(a, b)
    assert bool(s_grp.tree.counts.any())


@pytest.mark.parametrize("state", list(STATES))
def test_metrics_come_back_in_round_order(toy, state):
    # a long conflict-free prefix, then repeats; no refusal under horizon K
    seq = np.asarray(list(range(N)) * (K // N), np.int32)
    _, _, ms = _run_torch(toy, state, seq=seq, horizon=K, owner_parallel=True, max_group=None)
    np.testing.assert_array_equal(_np(ms["owner"]), seq)
    assert {name: tuple(v.shape) for name, v in ms.items()} == {
        name: (K,) for name in ("clip_frac", "max_grad_norm", "grad_noise_scale", "refused",
                                "owner")}
    assert not bool(ms["refused"].any())
    # round k's noise scale is its owner's
    _, _, m_seq = _run_torch(toy, state, seq=seq, horizon=K)
    assert torch.equal(ms["grad_noise_scale"], m_seq["grad_noise_scale"])


@pytest.mark.parametrize("state", list(STATES))
def test_exhaustion_refuses_the_sequential_rounds(toy, state):
    f_seq, s_seq, m_seq = _run_torch(toy, state)
    f_grp, s_grp, m_grp = _run_torch(toy, state, owner_parallel=True, max_group=None)
    refused = _np(m_grp["refused"])
    assert refused.any() and not refused.all()
    np.testing.assert_array_equal(refused, _np(m_seq["refused"]))
    np.testing.assert_array_equal(_np(m_grp["owner"]), _np(m_seq["owner"]))
    for name in ("spent", "refused"):
        assert torch.equal(getattr(s_grp.ledger, name), getattr(s_seq.ledger, name))
    assert int(s_grp.step) == int(s_seq.step) == K - int(refused.sum())
    assert f_grp.reconcile(s_grp) == f_seq.reconcile(s_seq)
    # a bounded deviation, not garbage: theta_L stays in Theta near the
    # sequential run's
    for a, b in zip(_theta_leaves(s_grp), _theta_leaves(s_seq), strict=True):
        assert bool(torch.isfinite(a).all()) and float(a.abs().max()) <= 10.0
        assert float((a - b).abs().max()) < 2.0


def test_schedule_drawn_grouped_run_matches_reference(toy):
    # owner_seq=None: the schedule's draw, then one host copy for the
    # partition; both packages draw the same owners
    params, data, _ = toy
    jf = _fed(jfed, "f32", horizon=K)
    js, jm = jf.run_rounds(jf.init_state({k: jnp.asarray(v) for k, v in params.items()}),
                           {k: jnp.asarray(v) for k, v in data.items()},
                           key=jax.random.PRNGKey(7), owner_parallel=True)
    tf = _fed(tfed, "f32", horizon=K, device=CPU)
    ts, tm = tf.run_rounds(tf.init_state(params_from_numpy(params, device=CPU)),
                           {k: torch.from_numpy(v) for k, v in data.items()},
                           key=trandom.PRNGKey(7, device=CPU), owner_parallel=True)
    np.testing.assert_array_equal(_np(tm["owner"]), np.asarray(jm["owner"]))
    np.testing.assert_allclose(_np(ts.theta_L.buf), np.asarray(js.theta_L.buf),
                               rtol=RTOL, atol=ATOL)
    _ledger_parity(tf.reconcile(ts), jf.reconcile(js))


# --------------------------- the batched plain versions ----------------------------
P_ODD = 1_031                      # not a multiple of 4 or of any block size


@pytest.mark.parametrize("g", [1, 3, 8])
def test_batched_plain_versions_equal_single_calls_bit_for_bit(g):
    gen = torch.Generator().manual_seed(g)
    tb = torch.randn(g, P_ODD, generator=gen)
    acc = torch.randn(g, P_ODD, generator=gen)
    keys = trandom.split(trandom.PRNGKey(g, device=CPU), g)
    gain = torch.rand(g, generator=gen)
    ns, w = torch.rand(g, generator=gen), torch.rand(g, generator=gen)
    kw = dict(sigma=1e-2, lr_own=0.3, lr_l=0.2, n_owners=16, theta_max=2.0)
    new_l, new_i = dops.dp_round_rows(tb, acc, keys, gain, ns, w, **kw)
    sq = dops.fused_sqnorm_rows(acc)
    assert new_l.shape == new_i.shape == (g, P_ODD) and sq.shape == (g,)
    for m in range(g):
        one_l, one_i = dops.dp_round_flat(tb[m], acc[m], keys[m], gain[m].reshape(()),
                                          ns[m:m + 1], w[m:m + 1], **kw)
        assert torch.equal(new_l[m], one_l) and torch.equal(new_i[m], one_i)
        assert torch.equal(sq[m], dops.fused_sqnorm(acc[m]))
    # tree_delta: g distinct owners of 10, depth 3, counts with r = 0..2
    # retired levels, one member refused
    nodes = torch.randn(10, 3, P_ODD, generator=gen)
    counts = torch.tensor([0, 1, 3, 2, 5, 6, 0, 1, 2, 3], dtype=torch.int32)
    owners = torch.randperm(10, generator=gen)[:g]
    grant = torch.ones(g, dtype=torch.int32)
    grant[-1] = 0
    batched, single = nodes.clone(), nodes.clone()
    delta = tops.tree_delta_rows_(batched, counts, owners, keys, ns, grant)
    for m in range(g):
        one = tops.tree_delta_(single, counts, owners[m:m + 1], keys[m], ns[m:m + 1],
                               grant[m:m + 1])
        assert torch.equal(delta[m], one)
    assert torch.equal(batched, single)
    assert torch.equal(batched, nodes) == (g == 1)       # only member 0 of g = 1 is refused


# ------------------------------ the reduced LM, end to end -------------------------
JAX_REDUCED = JaxModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab=50304).reduced()
N_LM, K_LM = 4, 8


def test_reduced_lm_grouped_rounds_match_reference():
    # the vmapped gradient through the dense LM (attention, MLP, the
    # embedding) with batched flat parameters, against jax.vmap
    jlm = jax_build_model(JAX_REDUCED, remat=False)
    jparams = jlm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, JAX_REDUCED.vocab, size=(K_LM, 4, 16),
                                             dtype=np.int32)
    data = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    seq = np.asarray([0, 1, 2, 3, 1, 0, 2, 2], np.int32)          # groups of 4, 3, 1
    out = []
    for mod in (jfed, tfed):
        owners = [mod.DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0) for i in range(N_LM)]
        kw = {} if mod is jfed else dict(device=CPU)
        fed = mod.Federation(owners, mod.FederationConfig.from_target_lr(
            0.05, n_owners=N_LM, horizon=2, sigma=1e-2, theta_max=100.0), **kw)
        priv = mod.PrivatizerConfig(xi=1.0, granularity="microbatch", n_microbatches=2,
                                    fused_kernel=True)
        if mod is jfed:
            fed.make_step(lambda p, b: jlm.loss(p, b)[0], privatizer=priv, pack_params=True)
            st = fed.init_state(jparams)
            st, ms = fed.run_rounds(st, {k: jnp.asarray(v) for k, v in data.items()},
                                    jnp.asarray(seq), key=jax.random.PRNGKey(5),
                                    owner_parallel=True, max_group=None)
            theta, bank = np.asarray(st.theta_L.buf), np.asarray(st.bank)
        else:
            lm = LM(DENSE_124M.reduced())
            fed.make_step(lambda p, b: lm.loss(p, b)[0], privatizer=priv, pack_params=True)
            st = fed.init_state(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                                  device=CPU))
            st, ms = fed.run_rounds(st, {k: torch.from_numpy(v) for k, v in data.items()},
                                    seq, key=trandom.PRNGKey(5, device=CPU),
                                    owner_parallel=True, max_group=None)
            theta, bank = _np(st.theta_L.buf), _np(st.bank)
        out.append((np.asarray(ms["refused"]), fed.reconcile(st), theta, bank))
    (j_ref, j_led, j_theta, j_bank), (t_ref, t_led, t_theta, t_bank) = out
    np.testing.assert_array_equal(t_ref, j_ref)
    assert t_ref.any()                                   # owner 2's third round
    _ledger_parity(t_led, j_led)
    np.testing.assert_allclose(t_theta, j_theta, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_bank, j_bank, rtol=RTOL, atol=ATOL)


# ----------------------------------- raising cases ---------------------------------
def _raises_bf16(toy):
    # a bf16 bank is a flat-engine storage: asked of a pytree state it
    # raises (the grouped driver itself runs bf16 banks, see below)
    params, data, seq = toy
    fed = _fed(tfed, "pytree", device=CPU)
    fed.init_state(params_from_numpy(params, device=CPU), bank_dtype=torch.bfloat16)


def _raises_max_group(toy):
    _run_torch(toy, "f32", owner_parallel=True, max_group=0)


def _raises_scattered_group(toy):
    params, data, seq = toy
    fed = _fed(tfed, "f32", device=CPU)
    st = fed.init_state(params_from_numpy(params, device=CPU))
    idx, valid = np.asarray([[0, 2]], np.int32), np.ones((1, 2), bool)
    fed._group_fn(st, {k: torch.from_numpy(v) for k, v in data.items()},
                  torch.from_numpy(seq), trandom.split(trandom.PRNGKey(0, device=CPU), K),
                  idx, valid)


def _raises_no_ledger(toy):
    params, data, seq = toy
    fed = _fed(tfed, "f32", device=CPU)
    st = fed.init_state(params_from_numpy(params, device=CPU))._replace(ledger=None)
    fed.run_rounds(st, {k: torch.from_numpy(v) for k, v in data.items()}, seq,
                   key=trandom.PRNGKey(0, device=CPU), owner_parallel=True)


def _raises_repeated_owner(toy):
    nodes = torch.zeros(4, 2, 8)
    tops.tree_delta_rows_(nodes, torch.zeros(4, dtype=torch.int32),
                          torch.tensor([1, 1]), trandom.split(trandom.PRNGKey(0, device=CPU), 2),
                          torch.ones(2))


RAISING = {
    "bf16 bank": (_raises_bf16, ValueError, "bank_dtype is a flat-engine option"),
    "max_group 0": (_raises_max_group, ValueError, "max_group must be >= 1"),
    "group not a consecutive run": (_raises_scattered_group, ValueError, "consecutive run"),
    "no device ledger": (_raises_no_ledger, ValueError, "device ledger"),
    "repeated owner in tree_delta_rows_": (_raises_repeated_owner, ValueError, "distinct"),
}


@pytest.mark.parametrize("case", list(RAISING))
def test_raising_cases(toy, case):
    fn, exc, match = RAISING[case]
    with pytest.raises(exc, match=match):
        fn(toy)


# ------------------------------- bf16 banks under the grouped driver ----------------------
def _bf16_run(mod, toy, owner_parallel, paged=False):
    params, data, seq = toy
    bf16 = torch.bfloat16 if mod is tfed else jnp.bfloat16
    extra = dict(device=CPU) if mod is tfed else {}
    fed = _fed(mod, "f32", **extra)
    priv = mod.PrivatizerConfig(xi=1.0, granularity="microbatch", n_microbatches=2,
                                fused_kernel=True)
    fed.make_step(_LOSS[mod], privatizer=priv, pack_params=True, bank_dtype=bf16)
    if mod is tfed:
        p = params_from_numpy(params, device=CPU)
        st = fed.init_paged_state(p, n_hot=N) if paged else fed.init_state(p)
        st, ms = fed.run_rounds(st, {k: torch.from_numpy(v) for k, v in data.items()}, seq,
                                key=trandom.PRNGKey(4, device=CPU),
                                owner_parallel=owner_parallel)
        return fed, st, {k: _np(v) for k, v in ms.items()}
    st = fed.init_state({k: jnp.asarray(v) for k, v in params.items()})
    st, ms = fed.run_rounds(st, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(seq),
                            key=jax.random.PRNGKey(4), owner_parallel=owner_parallel)
    return fed, st, {k: np.asarray(v) for k, v in ms.items()}


_LOSS = {
    jfed: lambda p, b: jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2),
    tfed: lambda p, b: torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2),
}


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_bf16_bank_under_grouped_owner_parallel(toy, paged):
    """The reference's contract (tests/test_sharded_engine.py): the grouped
    driver on a bf16 bank keeps the sequential bf16 run's refusal pattern
    and ledger spend exactly, writes its rows back in bf16, and theta_L
    stays finite within 2.0 of the sequential run; the refusals and the
    reconciled ledger also equal the reference's grouped bf16 run."""
    fs, ss, ms = _bf16_run(tfed, toy, owner_parallel=False, paged=paged)
    fg, sg, mg = _bf16_run(tfed, toy, owner_parallel=True, paged=paged)
    groups = tfed.partition_conflict_free(toy[2], tfed.auto_max_group(toy[2]))
    assert max(n for _, n in groups) > 1
    hot = sg.bank.hot if paged else sg.bank
    assert hot.dtype == torch.bfloat16
    assert ms["refused"].sum() > 0
    np.testing.assert_array_equal(ms["refused"], mg["refused"])
    np.testing.assert_array_equal(_np(ss.ledger.spent), _np(sg.ledger.spent))
    led = fg.reconcile(sg)
    assert led == fs.reconcile(ss)
    g = _np(sg.theta_L.buf)
    assert np.isfinite(g).all()
    assert np.max(np.abs(_np(ss.theta_L.buf) - g)) < 2.0
    jf, js, jm = _bf16_run(jfed, toy, owner_parallel=True)
    np.testing.assert_array_equal(mg["refused"], jm["refused"])
    np.testing.assert_array_equal(_np(sg.ledger.spent), np.asarray(js.ledger.spent))
    _ledger_parity(led, jf.reconcile(js))
