"""The port's fault layer (`repro_torch.federation.faults`) held against
the JAX reference on the CPU.

The reference's toy (3 owners, K = 12 rounds, n = 200 records each, a
linear model) goes through both packages with the same seeded numpy
inputs, owner sequence and keys. The reference runs its kernels' jnp
oracles; the port runs its plain versions on CPU tensors.

Exact across packages: the fault-code draws, the code validation, the
checksums of the same bank (f32, bf16, int8 and fp8 QuantBanks, pytree
banks; the chunked int64 sum included), `fault_tick`, `verify_row`,
`inject_nonfinite`, `finite_guard`, and after a fault-armed dispatch the
seven device-ledger columns, the fault windows, contacts and quarantine
flags, the step count and the reconciled ledger. A stored checksum
describes its bank row, so it equals the reference's exactly where the
rows are bit-equal (the owners no round changed) and equals
`bank_checksums` of the port's own bank everywhere. Within the port's
parity tolerance (rtol 1e-4, atol 1e-6; int8 codes within one step):
theta_L and the bank, as in tests/test_torch_grouped.py.

Inside the port, bit for bit: a step() loop equals run_rounds under the
same codes, a round rejected by each code (and by quarantine) is a no-op on
theta_L, the bank row, its checksum, the quantized codes, scales and
residual, and on tree states the nodes and counts (the two-launch
tree_delta: the nodes also equal the reference's bit for bit from a
carried-over state), and a zero plan equals the fault-off engine.

The reference's own driver-against-driver bit-parity tests are not
anchors here: `test_zero_fault_plan_matches_fault_off_engine[None]` and
`test_drivers_bit_identical_under_faults[int8]` fail on some XLA:CPU
hosts and pass on others.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federation as jfed
import repro.federation.faults as jfaults
import repro_torch.federation as tfed
import repro_torch.federation.faults as tfaults
from repro.federation.flatten import QuantBank as JQuantBank
from repro_torch import random as trandom
from repro_torch.convert import (device_ledger_from_numpy, fault_state_from_numpy,
                                 params_from_numpy, pytree_state_from_numpy,
                                 quant_bank_from_numpy, staleness_state_from_numpy)
from repro_torch.federation import QuantBank
from repro_torch.tree_util import tree_flatten

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-6
N, K = 3, 12
COLUMNS = ("spent", "refused", "dropped", "faulted", "quarantined", "timed_out", "retried")

# state: (make_step kwargs, Federation kwargs)
STATES = {
    "f32": (dict(pack_params=True), {}),
    "f32-unfused": (dict(pack_params=True, fused=False), {}),
    "int8": (dict(pack_params=True, bank_dtype="int8"), {}),
    "tree": (dict(pack_params=True), dict(mechanism="tree", tree_depth=2)),
    "pytree": (dict(pack_params=False), {}),
    # the tree in the reference mode: the members' node rows written one by
    # one from the deferred commits
    "tree-pytree": (dict(pack_params=False, fused=False), dict(mechanism="tree",
                                                               tree_depth=2)),
}
POLICY = dict(max_faults=2, window=8)
# an explicit trace that reaches every column: drops, a guard rejection of
# each kind, quarantine (owner 0 faults twice), timeouts with backoff
# (retries), refusals under horizon 3
SEQ = np.array([0, 1, 2, 0, 1, 0, 2, 1, 2, 0, 1, 1], np.int32)
CODES = np.array([3, 5, 1, 4, 0, 0, 2, 0, 5, 0, 0, 0], np.int8)


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
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal(6).astype(np.float32), "b": np.zeros((), np.float32)}
    data = {"x": rng.standard_normal((K, 4, 6)).astype(np.float32),
            "y": np.ones((K, 4), np.float32)}
    return params, data


def _loss(mod):
    if mod is jfed:
        return lambda p, b: jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
    return lambda p, b: torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _fed(mod, state, horizon=3, policy=POLICY, staleness=None, faults=True, **extra):
    step_kw, fed_kw = STATES[state]
    step_kw = dict(step_kw)
    priv = mod.PrivatizerConfig(xi=1.0, granularity="microbatch", n_microbatches=2,
                                fused_kernel=step_kw.pop("fused", True))
    if faults:
        fed_kw = dict(fed_kw, fault_policy=mod.FaultPolicy(**policy))
    if staleness is not None:
        fed_kw = dict(fed_kw, staleness=mod.StalenessPolicy(**staleness))
    if mod is tfed:
        extra = dict(extra, device=CPU)
    fed = mod.Federation([mod.DataOwner(n=200, epsilon=2.0, xi=1.0)] * N,
                         mod.FederationConfig(horizon=horizon, sigma=1e-2, theta_max=10.0,
                                              lr_scale=5.0), **fed_kw, **extra)
    fed.make_step(_loss(mod), privatizer=priv, **step_kw)
    return fed


def _init(mod, fed, params):
    if mod is jfed:
        return fed.init_state({k: jnp.asarray(v) for k, v in params.items()})
    return fed.init_state(params_from_numpy(params, device=CPU))


def _batches(mod, data, sl=slice(None)):
    if mod is jfed:
        return {k: jnp.asarray(v[sl]) for k, v in data.items()}
    return {k: torch.from_numpy(v[sl].copy()) for k, v in data.items()}


def _key(mod, seed):
    return jax.random.PRNGKey(seed) if mod is jfed else trandom.PRNGKey(seed, device=CPU)


def _run(mod, toy, state, seq=SEQ, codes=CODES, key=5, staleness=None, **kw):
    params, data = toy
    fed = _fed(mod, state, staleness=staleness)
    st = _init(mod, fed, params)
    faults = codes if codes is not None else None
    if mod is jfed:
        st, ms = fed.run_rounds(st, _batches(mod, data), jnp.asarray(seq), key=_key(mod, key),
                                faults=None if faults is None else jnp.asarray(faults), **kw)
    else:
        st, ms = fed.run_rounds(st, _batches(mod, data), seq, key=_key(mod, key),
                                faults=faults, **kw)
    return fed, st, ms


def _theta_leaves(st):
    theta = st.theta_L
    if isinstance(theta, (tfed.ParamFlat, jfed.ParamFlat)):
        return [theta.buf]
    return (tree_flatten(theta)[0] if isinstance(theta, dict) and isinstance(
        next(iter(theta.values())), torch.Tensor) else jax.tree_util.tree_leaves(theta))


def _bank_leaves(bank):
    if isinstance(bank, (QuantBank, JQuantBank)):
        return [bank.codes, bank.scales, bank.residual]
    if isinstance(bank, torch.Tensor) or isinstance(bank, dict) and isinstance(
            next(iter(bank.values())), torch.Tensor):
        return tree_flatten(bank)[0]
    return jax.tree_util.tree_leaves(bank)


def assert_states_match(ts, js, tf=None, jf=None, tm=None, jm=None):
    """The cross-package contract: counters exact, floats within tolerance."""
    for name in COLUMNS:
        np.testing.assert_array_equal(_np(getattr(ts.ledger, name)),
                                      np.asarray(getattr(js.ledger, name)), err_msg=name)
    for name in ("win_faults", "contacts", "quarantined"):
        np.testing.assert_array_equal(_np(getattr(ts.faults, name)),
                                      np.asarray(getattr(js.faults, name)), err_msg=name)
    assert (ts.stale is None) == (js.stale is None)
    if ts.stale is not None:
        for name in js.stale._fields:
            np.testing.assert_array_equal(_np(getattr(ts.stale, name)),
                                          np.asarray(getattr(js.stale, name)), err_msg=name)
    assert int(ts.step) == int(js.step)
    # the stored checksums describe the rows: the port's own bank's, and the
    # reference's wherever the rows are bit-equal
    assert torch.equal(ts.faults.checksum, tfaults.bank_checksums(ts.bank))
    t_rows, j_rows = _bank_leaves(ts.bank), _bank_leaves(js.bank)
    same = np.ones(N, bool)
    owner_rows = t_rows[:2] if isinstance(ts.bank, QuantBank) else t_rows
    j_owner_rows = j_rows[:2] if isinstance(ts.bank, QuantBank) else j_rows
    for t, j in zip(owner_rows, j_owner_rows):
        j = np.asarray(j)
        t = _np(t).view(j.dtype) if _np(t).dtype.itemsize == j.dtype.itemsize else _np(t)
        same &= (t.reshape(N, -1) == j.reshape(N, -1)).all(axis=1)
    np.testing.assert_array_equal(_np(ts.faults.checksum)[same],
                                  np.asarray(js.faults.checksum)[same])
    for t, j in zip(_theta_leaves(ts), _theta_leaves(js), strict=True):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=RTOL, atol=ATOL)
    if isinstance(ts.bank, QuantBank):
        jb = js.bank
        step = float(np.asarray(jb.scales).max())
        dcode = np.abs(_np(ts.bank.codes).astype(np.int32) - np.asarray(jb.codes).astype(np.int32))
        assert dcode.max() <= 1 and (dcode > 0).sum() <= 1
        np.testing.assert_allclose(_np(ts.bank.scales), np.asarray(jb.scales), rtol=1e-6, atol=0)
        assert np.abs(_np(ts.bank.residual) - np.asarray(jb.residual)).max() <= step
    else:
        for t, j in zip(t_rows, j_rows, strict=True):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=RTOL, atol=ATOL)
    if ts.tree is not None:
        np.testing.assert_array_equal(_np(ts.tree.counts), np.asarray(js.tree.counts))
        for t, j in zip(tree_flatten(ts.tree.nodes)[0], jax.tree_util.tree_leaves(js.tree.nodes)):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=RTOL, atol=ATOL)
    if tm is not None:
        assert set(tm) == set(jm)
        for name in tm:
            if name in ("clip_frac", "max_grad_norm", "grad_noise_scale"):
                np.testing.assert_allclose(_np(tm[name]), np.asarray(jm[name]),
                                           rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(_np(tm[name]), np.asarray(jm[name]),
                                              err_msg=name)
    if tf is not None:
        assert tf.reconcile(ts) == jf.reconcile(js)


# ------------------------------------ the draws --------------------------------------
PLANS = [dict(), dict(drop=0.3), dict(drop=0.1, stale=0.2, nonfinite=0.3, corrupt=0.4),
         dict(drop=0.25, stale=0.25, nonfinite=0.25, corrupt=0.25), dict(corrupt=1.0),
         dict(drop=0.2, stale=0.1, nonfinite=0.2, corrupt=0.2)]


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_fault_plan_draw_equals_reference(plan):
    for seed, k in ((0, 1), (3, 12), (11, 257)):
        t = tfed.FaultPlan(**PLANS[plan]).draw(trandom.PRNGKey(seed, device=CPU), k)
        j = jfed.FaultPlan(**PLANS[plan]).draw(jax.random.PRNGKey(seed), k)
        assert t.dtype == torch.int8 and t.shape == (k,)
        np.testing.assert_array_equal(_np(t), np.asarray(j))
    # salted: the codes do not come from the round key's own stream
    plan = tfed.FaultPlan(drop=0.5)
    key = trandom.PRNGKey(0, device=CPU)
    u = trandom.uniform(key, (64,))
    assert not torch.equal(plan.draw(key, 64), (u < 0.5).to(torch.int8))


CODE_CASES = {
    "list": ([0, 1, 2, 3, 4, 5], None),
    "int32 array": (np.array([5, 0, 2], np.int32), 3),
    "tensor": (torch.tensor([1, 1, 0]), 3),
    "2-D": (np.zeros((2, 2), np.int32), None),
    "float": (np.array([0.0, 1.0]), None),
    "wrong length": ([0, 1], 3),
    "out of range high": ([0, 6], None),
    "out of range low": ([-1, 0], None),
}


@pytest.mark.parametrize("case", list(CODE_CASES))
def test_as_fault_codes_validation_equals_reference(case):
    codes, k = CODE_CASES[case]
    jcodes = jnp.asarray(np.asarray(codes))
    try:
        want = np.asarray(jfed.as_fault_codes(jcodes, k))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(",")[0].split(" got")[0][:20]):
            tfed.as_fault_codes(codes, k, device=CPU)
        return
    got = tfed.as_fault_codes(codes, k, device=CPU)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("kw", [dict(drop=-0.1), dict(drop=0.6, corrupt=0.6),
                                dict(max_faults=0), dict(window=0)])
def test_plan_and_policy_validation(kw):
    cls = "FaultPolicy" if set(kw) & {"max_faults", "window"} else "FaultPlan"
    with pytest.raises(ValueError) as je:
        getattr(jfed, cls)(**kw)
    with pytest.raises(ValueError) as te:
        getattr(tfed, cls)(**kw)
    assert str(te.value) == str(je.value)


# ----------------------------------- checksums ---------------------------------------
def _f32_bank(rng, n, p):
    bank = rng.standard_normal((n, p)).astype(np.float32) * 1e3
    bank[0, :3] = [np.inf, -np.inf, np.nan]
    bank[1, 0] = -0.0
    return bank


def _banks():
    rng = np.random.default_rng(3)
    out = {"f32": (_f32_bank(rng, 4, 1031),) * 2}
    bf = jnp.asarray(rng.standard_normal((4, 517)), jnp.bfloat16)
    out["bf16"] = (bf, torch.from_numpy(np.asarray(bf).view(np.uint16).copy())
                   .view(torch.bfloat16))
    for fmt in ("int8", "fp8"):
        jb = jfed.init_flat_bank(jfed.pack_params({"w": jnp.zeros(1)}), 1, fmt)
        codes = rng.integers(-128 if fmt == "int8" else 0, 128 if fmt == "int8" else 256,
                             (5, 1031)).astype(np.int8 if fmt == "int8" else np.uint8)
        scales = rng.random((5, 1)).astype(np.float32)
        resid = rng.standard_normal(1031).astype(np.float32)
        jcodes = jnp.asarray(codes) if fmt == "int8" else jnp.asarray(codes).view(
            jnp.float8_e4m3fn)
        out[fmt] = (JQuantBank(jcodes, jnp.asarray(scales), jnp.asarray(resid), jb.codec),
                    quant_bank_from_numpy(codes, scales, resid, fmt, device=CPU))
    tree = {"a": _f32_bank(rng, 3, 40).reshape(3, 5, 8),
            "b": rng.integers(-2**31, 2**31 - 1, (3, 7)).astype(np.int32),
            "c": rng.standard_normal((3,)).astype(np.float32)}
    out["pytree"] = ({k: jnp.asarray(v) for k, v in tree.items()},
                     {k: torch.from_numpy(v.copy()) for k, v in tree.items()})
    return out


BANKS = _banks()


@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("kind", list(BANKS))
def test_checksums_equal_reference_bit_for_bit(kind, chunk, monkeypatch):
    if chunk is not None:
        # the chunked int64 sum of a long row, on a short one
        monkeypatch.setattr(tfaults, "_CHUNK", chunk)
    jbank, tbank = BANKS[kind]
    if isinstance(jbank, np.ndarray):
        jbank, tbank = jnp.asarray(jbank), torch.from_numpy(tbank.copy())
    want = np.asarray(jfaults.bank_checksums(jbank))
    got = tfaults.bank_checksums(tbank)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    for i in range(want.shape[0]):
        row = tfaults.row_checksum(tbank, torch.tensor([i]))
        assert row.shape == () and int(row) == int(np.asarray(jfaults.row_checksum(jbank, i)))


def test_quant_checksum_covers_codes_and_scales_not_residual():
    _, tbank = BANKS["int8"]
    before = tfaults.bank_checksums(tbank)
    tbank.residual.add_(1.0)
    assert torch.equal(tfaults.bank_checksums(tbank), before)
    for part in (tbank.codes, tbank.scales):
        saved = part[2].clone()
        part[2, 0] = part[2, 0] + 1
        after = tfaults.bank_checksums(tbank)
        assert not torch.equal(after[2], before[2]) and torch.equal(after[:2], before[:2])
        part[2].copy_(saved)
    tbank.residual.sub_(1.0)


def test_verify_guard_and_injection_equal_reference():
    rng = np.random.default_rng(4)
    bank = rng.standard_normal((3, 50)).astype(np.float32)
    jb, tb = jnp.asarray(bank), torch.from_numpy(bank.copy())
    csum = jfaults.bank_checksums(jb)
    tcs = tfaults.bank_checksums(tb)
    for i in range(3):
        for corrupt in (False, True):
            assert bool(tfaults.verify_row(tcs, tb, torch.tensor([i]), corrupt)) == bool(
                jfaults.verify_row(csum, jb, i, corrupt))
    # a genuinely corrupted row is caught without a code
    tb[1, 7] += 1.0
    assert not bool(tfaults.verify_row(tcs, tb, torch.tensor([1]), False))
    tree = {"x": bank[0], "y": bank[1:3]}
    for flag in (False, True):
        jt = jfaults.inject_nonfinite({k: jnp.asarray(v) for k, v in tree.items()}, flag)
        tt = tfaults.inject_nonfinite({k: torch.from_numpy(v.copy()) for k, v in tree.items()},
                                      torch.tensor(flag))
        for k in tree:
            np.testing.assert_array_equal(_np(tt[k]), np.asarray(jt[k]))
        assert bool(tfaults.finite_guard(tt)) == bool(jfaults.finite_guard(jt)) == (not flag)
    flags = np.array([True, False, True])
    jt = jfaults.inject_nonfinite(jnp.asarray(bank), jnp.asarray(flags))
    tt = tfaults.inject_nonfinite(torch.from_numpy(bank.copy()), torch.from_numpy(flags))
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_array_equal(_np(tfaults.finite_guard_rows(tt)),
                                  np.asarray(jax.vmap(jfaults.finite_guard)(jt)))


# ------------------------------------ the ticks --------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_fault_tick_and_update_checksum_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = 6
    pol = dict(max_faults=int(rng.integers(1, 4)), window=int(rng.integers(1, 5)))
    jpol, tpol = jfed.FaultPolicy(**pol), tfed.FaultPolicy(**pol)
    bank = rng.standard_normal((n, 9)).astype(np.float32)
    js = jfaults.init_fault_state(jnp.asarray(bank), n)
    ts = tfaults.init_fault_state(torch.from_numpy(bank.copy()), n)
    for _ in range(30):
        if rng.random() < 0.5:
            o = int(rng.integers(n))
            f, a = bool(rng.random() < 0.5), bool(rng.random() < 0.8)
            js = jfaults.fault_tick(js, jnp.int32(o), jnp.bool_(f), jpol, jnp.bool_(a))
            tfaults.fault_tick(ts, torch.tensor([o]), torch.tensor(f), tpol, torch.tensor(a))
        else:
            g = int(rng.integers(1, n + 1))
            o = rng.permutation(n)[:g]
            f, a = rng.random(g) < 0.5, rng.random(g) < 0.8
            js = jfaults.fault_tick(js, jnp.asarray(o, jnp.int32), jnp.asarray(f), jpol,
                                    jnp.asarray(a))
            tfaults.fault_tick(ts, torch.from_numpy(o), torch.from_numpy(f), tpol,
                               torch.from_numpy(a))
        for name in js._fields:
            np.testing.assert_array_equal(_np(getattr(ts, name)), np.asarray(getattr(js, name)))
    # the stored checksum follows the written rows where applied
    bank[[1, 4]] += 1.0
    apply = np.array([True, False])
    js = jfaults.update_checksum(js, jnp.asarray(bank), jnp.asarray([1, 4], jnp.int32),
                                 jnp.asarray(apply))
    tfaults.update_checksum(ts, torch.from_numpy(bank.copy()), torch.tensor([1, 4]),
                            torch.from_numpy(apply))
    np.testing.assert_array_equal(_np(ts.checksum), np.asarray(js.checksum))


# -------------------------- the drivers against the reference ------------------------
@pytest.mark.parametrize("driver", ["fused", "grouped"])
@pytest.mark.parametrize("state", list(STATES))
def test_code_trace_dispatch_matches_reference(toy, state, driver):
    # staleness armed so that TIMEOUT backs off and retries reach the ledger
    stale = dict(max_retries=1, backoff_cap=2)
    kw = dict(owner_parallel=True, max_group=None) if driver == "grouped" else {}
    jf, js, jm = _run(jfed, toy, state, staleness=stale, **kw)
    tf, ts, tm = _run(tfed, toy, state, staleness=stale, **kw)
    led = {name: _np(getattr(ts.ledger, name)) for name in COLUMNS}
    assert all(led[name].any() for name in COLUMNS), led          # every column hit
    assert_states_match(ts, js, tf, jf, tm, jm)


def test_mid_session_state_carried_from_reference(toy):
    # a pytree state part-way through a faulted session, carried across
    # with the converters (ledger, fault and runtime counters), then both
    # packages run the rest of the trace
    params, data = toy
    stale = dict(max_retries=1, backoff_cap=2)
    jf = _fed(jfed, "pytree", staleness=stale)
    js = _init(jfed, jf, params)
    js, _ = jf.run_rounds(js, _batches(jfed, data, slice(0, 6)), jnp.asarray(SEQ[:6]),
                          key=jax.random.PRNGKey(1), faults=jnp.asarray(CODES[:6]))
    tf = _fed(tfed, "pytree", staleness=stale)
    led = js.ledger
    ts = pytree_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js.theta_L), jax.tree_util.tree_map(
            np.asarray, js.bank), int(js.step),
        ledger=device_ledger_from_numpy(*(np.asarray(getattr(led, c)) for c in (
            "spent", "cap", "refused", "dropped", "faulted", "quarantined", "timed_out",
            "retried")), sid=1, device=CPU),
        faults=fault_state_from_numpy(*map(np.asarray, js.faults), device=CPU),
        stale=staleness_state_from_numpy(*map(np.asarray, js.stale), device=CPU), device=CPU)
    tf.mechanism.device_ledger(CPU)            # the session's snapshot generation 1
    rest = slice(6, K)
    js, jm = jf.run_rounds(js, _batches(jfed, data, rest), jnp.asarray(SEQ[rest]),
                           key=jax.random.PRNGKey(2), faults=jnp.asarray(CODES[rest]))
    ts, tm = tf.run_rounds(ts, _batches(tfed, data, rest), SEQ[rest],
                           key=trandom.PRNGKey(2, device=CPU), faults=CODES[rest])
    assert_states_match(ts, js, tm=tm, jm=jm)
    # the host sessions folded different baselines (the reference's first
    # six rounds, the port's none), so only the device columns compare here


# -------------------------------- contracts inside the port --------------------------
def _snapshot(st):
    """Copies of the state's tensors by part."""
    parts = {"theta": _theta_leaves(st), "bank": _bank_leaves(st.bank), "step": [st.step],
             "ledger": [getattr(st.ledger, c) for c in COLUMNS]}
    if st.faults is not None:
        parts["faults"] = list(st.faults)
    if st.stale is not None:
        parts["stale"] = list(st.stale)
    if st.tree is not None:
        parts["nodes"] = tree_flatten(st.tree.nodes)[0]
        parts["counts"] = [st.tree.counts]
    return {k: [t.clone() for t in v] for k, v in parts.items()}


def _equal_parts(a, b, names):
    for name in names:
        assert len(a[name]) == len(b[name]), name
        for x, y in zip(a[name], b[name]):
            assert torch.equal(x, y), name


@pytest.mark.parametrize("state", list(STATES))
def test_step_loop_equals_run_rounds_bit_for_bit(toy, state):
    params, data = toy
    stale = dict(max_retries=1, backoff_cap=2, decay=0.8)
    f_run, s_run, m_run = _run(tfed, toy, state, staleness=stale)
    fed = _fed(tfed, state, staleness=stale)
    st = _init(tfed, fed, params)
    keys = trandom.split(trandom.PRNGKey(5, device=CPU), K)
    for k in range(K):
        st, m = fed.step(st, {n: torch.from_numpy(v[k]) for n, v in data.items()}, int(SEQ[k]),
                         keys[k], fault_code=int(CODES[k]))
        for name in ("refused", "dropped", "faulted", "quarantined", "timed_out", "retried"):
            assert m[name] == bool(m_run[name][k]), (k, name)
    a, b = _snapshot(st), _snapshot(s_run)
    # the step loop's state ledger is the host's to keep (step() is
    # host-authorized); everything else equals the K-round dispatch
    _equal_parts(a, b, [name for name in a if name != "ledger"])
    assert fed.ledger() == f_run.reconcile(s_run)


REJECTIONS = ["DROP", "STALE", "NONFINITE_GRAD", "CORRUPT_PAYLOAD", "TIMEOUT", "quarantine",
              "backoff"]


def _rejected_round(toy, state, how):
    """Warm a state with granted rounds, put owner 1 in the rejecting
    condition, run one round of owner 1; returns (before, after, metrics)."""
    params, data = toy
    fed = _fed(tfed, state, horizon=16, policy=dict(max_faults=1, window=8),
               staleness=dict(max_retries=2, backoff_cap=2, decay=0.7))
    st = _init(tfed, fed, params)
    st, _ = fed.run_rounds(st, _batches(tfed, data, slice(0, 6)), [0, 1, 2, 0, 2, 0],
                           key=trandom.PRNGKey(3, device=CPU))
    code = tfaults.OK
    if how == "quarantine":
        st, _ = fed.run_rounds(st, _batches(tfed, data, slice(6, 7)), [1],
                               key=trandom.PRNGKey(4, device=CPU), faults=[tfaults.STALE])
        assert bool(st.faults.quarantined[1])
    elif how == "backoff":
        st, _ = fed.run_rounds(st, _batches(tfed, data, slice(6, 7)), [1],
                               key=trandom.PRNGKey(4, device=CPU), faults=[tfaults.TIMEOUT])
        assert int(st.stale.cooldown[1]) > 0
    else:
        code = getattr(tfaults, how)
    before = _snapshot(st)
    st, m = fed.run_rounds(st, _batches(tfed, data, slice(7, 8)), [1],
                           key=trandom.PRNGKey(9, device=CPU), faults=[code])
    return before, _snapshot(st), m, st


@pytest.mark.parametrize("how", REJECTIONS)
@pytest.mark.parametrize("state", list(STATES))
def test_rejected_round_is_a_bit_exact_no_op(toy, state, how):
    before, after, m, st = _rejected_round(toy, state, how)
    _equal_parts(before, after, [n for n in ("theta", "bank", "step", "nodes", "counts")
                                 if n in before])
    assert torch.equal(before["faults"][0], after["faults"][0])         # the checksums
    assert torch.equal(after["faults"][0], tfaults.bank_checksums(st.bank))
    flag = {"DROP": "dropped", "TIMEOUT": "timed_out", "quarantine": "quarantined",
            "backoff": "retried"}.get(how, "faulted")
    assert bool(m[flag][0]) and not bool(m["refused"][0])


def test_tree_rejections_keep_the_reference_nodes_bit_for_bit(toy):
    # the two-launch tree_delta: from the reference's own mid-run state, a
    # round rejected by each guard leaves the port's nodes equal to the
    # reference's, bit for bit
    params, data = toy
    jf = _fed(jfed, "tree", horizon=16, policy=dict(max_faults=99, window=8),
              staleness=dict(max_retries=0))
    js = _init(jfed, jf, params)
    js, _ = jf.run_rounds(js, _batches(jfed, data, slice(0, 5)), jnp.asarray([0, 1, 2, 1, 0]),
                          key=jax.random.PRNGKey(3))
    tf = _fed(tfed, "tree", horizon=16, policy=dict(max_faults=99, window=8),
              staleness=dict(max_retries=0))
    ts = _init(tfed, tf, params)
    ts.theta_L.buf.copy_(torch.from_numpy(np.array(js.theta_L.buf)))
    ts.bank.copy_(torch.from_numpy(np.array(js.bank)))
    ts.tree.nodes.copy_(torch.from_numpy(np.array(js.tree.nodes)))
    ts.tree.counts.copy_(torch.from_numpy(np.array(js.tree.counts)))
    for part, ref in ((ts.faults, js.faults), (ts.stale, js.stale)):
        for f in ref._fields:
            getattr(part, f).copy_(torch.from_numpy(np.array(getattr(ref, f))))
    for c in COLUMNS:
        getattr(ts.ledger, c).copy_(torch.from_numpy(np.array(getattr(js.ledger, c))))
    ts = ts._replace(step=torch.tensor(int(js.step), dtype=torch.int32))
    nodes0 = ts.tree.nodes.clone()
    for i, code in enumerate((tfaults.STALE, tfaults.NONFINITE_GRAD, tfaults.CORRUPT_PAYLOAD,
                              tfaults.TIMEOUT)):
        sl = slice(5 + i, 6 + i)
        # spread over the owners: a rejected round is answered, and spends
        owner = (2, 0, 1, 2)[i]
        js, jm = jf.run_rounds(js, _batches(jfed, data, sl), jnp.asarray([owner]),
                               key=jax.random.PRNGKey(10 + i), faults=jnp.asarray([code]))
        ts, tm = tf.run_rounds(ts, _batches(tfed, data, sl), [owner],
                               key=trandom.PRNGKey(10 + i, device=CPU), faults=[code])
        assert not bool(tm["refused"][0]) and int(ts.step) == int(js.step)
        np.testing.assert_array_equal(_np(ts.tree.nodes), np.asarray(js.tree.nodes))
        np.testing.assert_array_equal(_np(ts.tree.counts), np.asarray(js.tree.counts))
        np.testing.assert_array_equal(_np(ts.faults.checksum), np.asarray(js.faults.checksum))
    assert torch.equal(ts.tree.nodes, nodes0)


@pytest.mark.parametrize("driver", ["fused", "grouped"])
@pytest.mark.parametrize("state", list(STATES))
def test_zero_plan_equals_fault_off_engine_bit_for_bit(toy, state, driver):
    params, data = toy
    kw = dict(owner_parallel=True, max_group=None) if driver == "grouped" else {}
    out = []
    for armed in (False, True):
        fed = _fed(tfed, state, faults=armed,
                   staleness=dict() if armed else None)
        st = _init(tfed, fed, params)
        extra = dict(faults=tfed.FaultPlan(), latency=tfed.LatencyPlan()) if armed else {}
        st, m = fed.run_rounds(st, _batches(tfed, data), SEQ, key=trandom.PRNGKey(5, device=CPU),
                               **kw, **extra)
        out.append((st, m, fed.reconcile(st)))
    (s0, m0, l0), (s1, m1, l1) = out
    a, b = _snapshot(s0), _snapshot(s1)
    _equal_parts(a, b, [n for n in ("theta", "bank", "step", "nodes", "counts") if n in a])
    _equal_parts(a, b, ["ledger"])
    for name in m0:
        assert torch.equal(m0[name], m1[name]), name
    assert l0 == l1
    assert not any(bool(m1[c].any()) for c in ("dropped", "faulted", "timed_out", "retried"))


# --------------------------------------- raising -------------------------------------
def _unarmed_run(toy):
    params, data = toy
    fed = _fed(tfed, "f32", faults=False)
    st = _init(tfed, fed, params)
    fed.run_rounds(st, _batches(tfed, data), SEQ, key=trandom.PRNGKey(0, device=CPU),
                   faults=CODES)


def _unarmed_step(toy):
    params, data = toy
    fed = _fed(tfed, "f32", faults=False)
    fed.step(_init(tfed, fed, params), {k: torch.from_numpy(v[0]) for k, v in data.items()}, 0,
             trandom.PRNGKey(0, device=CPU), fault_code=tfaults.DROP)


def _unarmed_driver(toy):
    params, data = toy
    fed = _fed(tfed, "f32", faults=False)
    fed._fused_fn(_init(tfed, fed, params), _batches(tfed, data), torch.from_numpy(SEQ),
                  trandom.split(trandom.PRNGKey(0, device=CPU), K),
                  torch.zeros(K, dtype=torch.int8))


def _bad_codes(toy):
    _run(tfed, toy, "f32", codes=np.full(K, 7, np.int8))


def _policy_mismatch(toy):
    params, data = toy
    armed = _fed(tfed, "f32")
    plain = _fed(tfed, "f32", faults=False)
    plain._fused_fn(_init(tfed, armed, params), _batches(tfed, data), torch.from_numpy(SEQ),
                    trandom.split(trandom.PRNGKey(0, device=CPU), K))


RAISING = {
    "codes on an unarmed state": (_unarmed_run, "fault-armed state"),
    "fault_code in step on an unarmed state": (_unarmed_step, "fault-armed state"),
    "codes to an unarmed driver": (_unarmed_driver, "fault-armed state"),
    "codes out of range": (_bad_codes, "fault codes must lie in"),
    "fault counters under a fault-free config": (_policy_mismatch, "cfg.fault_policy is None"),
}


@pytest.mark.parametrize("case", list(RAISING))
def test_raising_cases(toy, case):
    fn, match = RAISING[case]
    with pytest.raises(ValueError, match=match):
        fn(toy)
