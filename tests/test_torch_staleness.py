"""The port's asynchronous runtime (`repro_torch.federation.staleness`)
held against the JAX reference on the CPU.

The reference's toy (3 owners, K = 12 rounds, n = 200 records each, a
linear model) goes through both packages with the same seeded numpy
inputs, owner sequence and keys, under a FaultPlan plus a LatencyPlan
(deadline, retries with backoff, decay 0.9 all armed).

Exact across packages: `LatencyPlan.draw` (zero and non-zero jitter, a
scalar and a per-owner base), `merge_timeout_codes` with and without tick
times, the validation of `as_tick_times` and of the plans and policies,
`staleness_tick`, and after a dispatch on the sequential and the grouped
driver the seven device-ledger columns, the fault windows, contacts and
quarantine flags, every StalenessState counter, the step count and the
reconciled ledger; a schedule-drawn Poisson run (its own tick times tighten
the deadlines) gives the reference's owners and codes. `staleness_weight`
(decay ** age, one helper for every driver) is held within 1 ulp of XLA's
pow. theta_L and the bank within the port's parity tolerance (rtol 1e-4,
atol 1e-6; int8 codes within one step).

Inside the port, bit for bit: a step() loop equals run_rounds with the
runtime armed; a zero plan with a default StalenessPolicy equals the
fault-off engine; reconcile folds timed_out and retried exactly and a
tampered ledger raises.

The reference's `test_drivers_bit_identical_under_runtime[int8]` is not an
anchor here: it fails on some XLA:CPU hosts and passes on others.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federation as jfed
import repro.federation.staleness as jstale
import repro_torch.federation as tfed
import repro_torch.federation.staleness as tstale
from repro.federation.flatten import QuantBank as JQuantBank
from repro_torch import random as trandom
from repro_torch.convert import params_from_numpy
from repro_torch.federation import QuantBank
from repro_torch.federation.deep import AsyncDPConfig, init_state
from repro_torch.federation.mechanisms import LedgerDriftError
from repro_torch.tree_util import tree_flatten

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-6
N, K = 3, 12
COLUMNS = ("spent", "refused", "dropped", "faulted", "quarantined", "timed_out", "retried")
STATES = {
    "f32": (dict(pack_params=True), {}),
    "f32-unfused": (dict(pack_params=True, fused=False), {}),
    "int8": (dict(pack_params=True, bank_dtype="int8"), {}),
    "tree": (dict(pack_params=True), dict(mechanism="tree", tree_depth=3)),
    "pytree": (dict(pack_params=False), {}),
}
PLAN = dict(drop=0.1, stale=0.05, nonfinite=0.1, corrupt=0.1)
LATENCY = dict(base=(0.2, 0.5, 0.8), jitter=0.4)
POLICY = dict(max_faults=2, window=8)
RUNTIME = dict(deadline=1.0, max_retries=2, backoff_cap=2, decay=0.9)
SEQ = np.array([0, 1, 2, 2, 0, 1, 1, 2, 0, 0, 1, 2], np.int32)


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


def _fed(mod, state, horizon=6, staleness=RUNTIME, fault_policy=POLICY, **extra):
    step_kw, fed_kw = STATES[state]
    step_kw = dict(step_kw)
    priv = mod.PrivatizerConfig(xi=1.0, granularity="microbatch", n_microbatches=2,
                                fused_kernel=step_kw.pop("fused", True))
    if fault_policy is not None:
        fed_kw = dict(fed_kw, fault_policy=mod.FaultPolicy(**fault_policy))
    if staleness is not None:
        fed_kw = dict(fed_kw, staleness=mod.StalenessPolicy(**staleness))
    if mod is jfed:
        def loss(p, b):
            return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
    else:
        extra = dict(extra, device=CPU)

        def loss(p, b):
            return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
    fed = mod.Federation([mod.DataOwner(n=200, epsilon=2.0, xi=1.0)] * N,
                         mod.FederationConfig(horizon=horizon, sigma=1e-2, theta_max=10.0,
                                              lr_scale=5.0), **fed_kw, **extra)
    fed.make_step(loss, privatizer=priv, **step_kw)
    return fed


def _run(mod, toy, state, seq=SEQ, key=8, plan=True, **kw):
    params, data = toy
    fed = _fed(mod, state)
    if mod is jfed:
        st = fed.init_state({k: jnp.asarray(v) for k, v in params.items()})
        st, ms = fed.run_rounds(
            st, {k: jnp.asarray(v) for k, v in data.items()},
            None if seq is None else jnp.asarray(seq), key=jax.random.PRNGKey(key),
            faults=jfed.FaultPlan(**PLAN) if plan else None,
            latency=jfed.LatencyPlan(**LATENCY), **kw)
    else:
        st = fed.init_state(params_from_numpy(params, device=CPU))
        st, ms = fed.run_rounds(
            st, {k: torch.from_numpy(v) for k, v in data.items()}, seq,
            key=trandom.PRNGKey(key, device=CPU),
            faults=tfed.FaultPlan(**PLAN) if plan else None,
            latency=tfed.LatencyPlan(**LATENCY), **kw)
    return fed, st, ms


# ----------------------------------- the draws ---------------------------------------
@pytest.mark.parametrize("plan", [dict(), dict(base=0.3), dict(base=(0.1, 0.5, 2.0)),
                                  dict(jitter=0.5), dict(base=(0.0, 1.0, 0.25), jitter=2.0)])
def test_latency_plan_draw_equals_reference(plan):
    seq = np.asarray([0, 2, 1, 1, 0, 2, 2, 0, 1, 0, 2, 1, 0], np.int32)
    for seed in (0, 5):
        t = tfed.LatencyPlan(**plan).draw(trandom.PRNGKey(seed, device=CPU),
                                          torch.from_numpy(seq))
        j = jfed.LatencyPlan(**plan).draw(jax.random.PRNGKey(seed), jnp.asarray(seq))
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(_np(t), np.asarray(j))


@pytest.mark.parametrize("with_times", [False, True])
def test_merge_timeout_codes_equals_reference(with_times):
    rng = np.random.default_rng(2 + with_times)
    codes = rng.integers(0, 6, 64).astype(np.int8)
    lat = (rng.exponential(1.0, 64)).astype(np.float32)
    times = np.sort(rng.uniform(0, 30, 64)).astype(np.float32) if with_times else None
    for deadline in (0.5, 1.5, math.inf):
        want = jstale.merge_timeout_codes(jnp.asarray(codes), jnp.asarray(lat), deadline,
                                          times=None if times is None else jnp.asarray(times))
        got = tstale.merge_timeout_codes(torch.from_numpy(codes), torch.from_numpy(lat),
                                         deadline,
                                         times=None if times is None else torch.from_numpy(times))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    # the reference's contract example
    out = tstale.merge_timeout_codes(torch.tensor([0, 1, 0, 4], dtype=torch.int8),
                                     torch.tensor([0.5, 9.0, 2.0, 2.0]), 1.0)
    assert out.tolist() == [0, 1, 5, 5]
    out = tstale.merge_timeout_codes(torch.zeros(4, dtype=torch.int8), torch.full((4,), 0.5),
                                     math.inf, times=torch.tensor([0.0, 0.1, 0.2, 10.0]))
    assert out.tolist() == [5, 5, 0, 0]
    with pytest.raises(ValueError, match="latencies"):
        tstale.merge_timeout_codes(torch.zeros(4, dtype=torch.int8), torch.zeros(2), 1.0)
    with pytest.raises(ValueError, match="tick times"):
        tstale.merge_timeout_codes(torch.zeros(4, dtype=torch.int8), torch.zeros(4), 1.0,
                                   times=torch.zeros(2))


TIMES_CASES = {
    "ok": ([0.0, 1.0, 1.0, 2.5], 4),
    "tensor": (torch.tensor([0.0, 3.0]), 2),
    "2-D": (np.zeros((2, 2)), None),
    "wrong length": ([0.0, 1.0, 2.0, 3.0], 3),
    "not finite": ([0.0, np.nan], None),
    "infinite": ([0.0, np.inf], None),
    "decreasing": ([1.0, 0.5], None),
}


@pytest.mark.parametrize("case", list(TIMES_CASES))
def test_as_tick_times_validation_equals_reference(case):
    times, k = TIMES_CASES[case]
    try:
        want = np.asarray(jfed.as_tick_times(np.asarray(times), k))
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tfed.as_tick_times(times, k, device=CPU)
        assert str(te.value) == str(e)
        return
    got = tfed.as_tick_times(times, k, device=CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("cls,kw", [
    ("LatencyPlan", dict(base=-1.0)), ("LatencyPlan", dict(jitter=-0.5)),
    ("LatencyPlan", dict(base=((1.0,),))), ("StalenessPolicy", dict(deadline=0.0)),
    ("StalenessPolicy", dict(max_retries=-1)), ("StalenessPolicy", dict(backoff_cap=31)),
    ("StalenessPolicy", dict(decay=0.0)), ("StalenessPolicy", dict(decay=1.5))])
def test_plan_and_policy_validation(cls, kw):
    with pytest.raises(ValueError) as je:
        getattr(jfed, cls)(**kw)
    with pytest.raises(ValueError) as te:
        getattr(tfed, cls)(**kw)
    assert str(te.value) == str(je.value)


# ------------------------------------- the ticks -------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_staleness_tick_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n = 6
    pol = dict(max_retries=int(rng.integers(0, 3)), backoff_cap=int(rng.integers(0, 4)),
               decay=0.9)
    jp, tp = jfed.StalenessPolicy(**pol), tfed.StalenessPolicy(**pol)
    js = jstale.init_staleness_state(n, jp)
    ts = tstale.init_staleness_state(n, tp, device=CPU)
    for _ in range(40):
        if rng.random() < 0.5:
            o = int(rng.integers(n))
            f = [bool(rng.random() < p) for p in (0.3, 0.4, 0.4, 0.9)]
            js = jstale.staleness_tick(js, jnp.int32(o), js.clock, is_retry=jnp.bool_(f[0]),
                                       apply=jnp.bool_(f[1]), timed=jnp.bool_(f[2]), policy=jp,
                                       active=jnp.bool_(f[3]), ticks=1)
            tstale.staleness_tick(ts, torch.tensor([o]), ts.clock, is_retry=torch.tensor(f[0]),
                                  apply=torch.tensor(f[1]), timed=torch.tensor(f[2]),
                                  policy=tp, active=torch.tensor(f[3]), ticks=1)
        else:
            g = int(rng.integers(1, n + 1))
            o = rng.permutation(n)[:g]
            f = [rng.random(g) < p for p in (0.3, 0.4, 0.4, 0.9)]
            t = np.asarray(js.clock) + np.arange(g, dtype=np.int32)
            js = jstale.staleness_tick(js, jnp.asarray(o, jnp.int32), jnp.asarray(t),
                                       is_retry=jnp.asarray(f[0]), apply=jnp.asarray(f[1]),
                                       timed=jnp.asarray(f[2]), policy=jp,
                                       active=jnp.asarray(f[3]), ticks=g)
            tstale.staleness_tick(ts, torch.from_numpy(o), torch.from_numpy(t),
                                  is_retry=torch.from_numpy(f[0]), apply=torch.from_numpy(f[1]),
                                  timed=torch.from_numpy(f[2]), policy=tp,
                                  active=torch.from_numpy(f[3]), ticks=g)
        for name in js._fields:
            np.testing.assert_array_equal(_np(getattr(ts, name)), np.asarray(getattr(js, name)),
                                          err_msg=name)


@pytest.mark.parametrize("decay", [0.9, 0.5, 0.999, 1e-3])
def test_staleness_weight_within_one_ulp_of_reference(decay):
    # torch.pow and XLA's pow are different f32 implementations: held to 1 ulp
    n = 64
    pol_j, pol_t = jfed.StalenessPolicy(decay=decay), tfed.StalenessPolicy(decay=decay)
    # ages 0 to 499: at decay 0.5 past 126 and at 1e-3 past 12 the weight
    # falls below the smallest normal f32, which both give as 0
    last = np.random.default_rng(1).integers(0, 500, n).astype(np.int32)
    js = jstale.init_staleness_state(n, pol_j)._replace(last_grant=jnp.asarray(last))
    ts = tstale.init_staleness_state(n, pol_t, device=CPU)._replace(
        last_grant=torch.from_numpy(last.copy()))
    t = np.int32(500)
    owners = np.arange(n, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda o: jstale.staleness_weight(js, o, t, pol_j))(owners))
    got = _np(tstale.staleness_weight(ts, torch.from_numpy(owners), torch.full((n,), 500),
                                      pol_t))
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    one = tstale.staleness_weight(ts, torch.tensor([3]), torch.tensor(500, dtype=torch.int32),
                                  pol_t)
    assert one.shape == () and float(one) == float(got[3])


# --------------------------- the drivers against the reference -----------------------
def _assert_match(ts, js, tm, jm):
    for name in COLUMNS:
        np.testing.assert_array_equal(_np(getattr(ts.ledger, name)),
                                      np.asarray(getattr(js.ledger, name)), err_msg=name)
    for name in ("win_faults", "contacts", "quarantined"):
        np.testing.assert_array_equal(_np(getattr(ts.faults, name)),
                                      np.asarray(getattr(js.faults, name)), err_msg=name)
    for name in js.stale._fields:
        np.testing.assert_array_equal(_np(getattr(ts.stale, name)),
                                      np.asarray(getattr(js.stale, name)), err_msg=name)
    assert int(ts.step) == int(js.step)
    assert torch.equal(ts.faults.checksum, tfed.bank_checksums(ts.bank))
    assert set(tm) == set(jm)
    for name in tm:
        if name in ("clip_frac", "max_grad_norm", "grad_noise_scale"):
            np.testing.assert_allclose(_np(tm[name]), np.asarray(jm[name]), rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(_np(tm[name]), np.asarray(jm[name]), err_msg=name)
    theta_t = ([ts.theta_L.buf] if isinstance(ts.theta_L, tfed.ParamFlat)
               else tree_flatten(ts.theta_L)[0])
    theta_j = ([js.theta_L.buf] if isinstance(js.theta_L, jfed.ParamFlat)
               else jax.tree_util.tree_leaves(js.theta_L))
    for t, j in zip(theta_t, theta_j, strict=True):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=RTOL, atol=ATOL)
    if isinstance(ts.bank, QuantBank):
        assert isinstance(js.bank, JQuantBank)
        step = float(np.asarray(js.bank.scales).max())
        dcode = np.abs(_np(ts.bank.codes).astype(np.int32)
                       - np.asarray(js.bank.codes).astype(np.int32))
        assert dcode.max() <= 1 and (dcode > 0).sum() <= 1
        np.testing.assert_allclose(_np(ts.bank.scales), np.asarray(js.bank.scales), rtol=1e-6,
                                   atol=0)
        assert np.abs(_np(ts.bank.residual) - np.asarray(js.bank.residual)).max() <= step
    else:
        for t, j in zip(tree_flatten(ts.bank)[0], jax.tree_util.tree_leaves(js.bank),
                        strict=True):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=RTOL, atol=ATOL)
    if ts.tree is not None:
        np.testing.assert_array_equal(_np(ts.tree.counts), np.asarray(js.tree.counts))
        np.testing.assert_allclose(_np(ts.tree.nodes), np.asarray(js.tree.nodes), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("driver", ["fused", "grouped"])
@pytest.mark.parametrize("state", list(STATES))
def test_plan_and_latency_dispatch_matches_reference(toy, state, driver):
    kw = dict(owner_parallel=True, max_group=None) if driver == "grouped" else {}
    jf, js, jm = _run(jfed, toy, state, **kw)
    tf, ts, tm = _run(tfed, toy, state, **kw)
    got = {c: int(getattr(ts.ledger, c).sum()) for c in COLUMNS}
    assert all(got[c] for c in COLUMNS if c != "refused"), got         # every outcome
    assert int(ts.stale.last_grant.max()) > 0                          # decay saw ages
    _assert_match(ts, js, tm, jm)
    assert tf.reconcile(ts) == jf.reconcile(js)


def test_schedule_drawn_times_match_reference(toy):
    # owner_seq=None with a Poisson schedule: its arrival instants tighten
    # the deadlines; owners, codes and the ledger equal the reference's
    out = []
    for mod in (jfed, tfed):
        params, data = toy
        fed = _fed(mod, "f32", horizon=64, staleness=dict(deadline=math.inf, max_retries=1))
        fed.schedule = mod.PoissonSchedule(rate=1.0)
        if mod is jfed:
            st = fed.init_state({k: jnp.asarray(v) for k, v in params.items()})
            st, m = fed.run_rounds(st, {k: jnp.asarray(v) for k, v in data.items()}, None,
                                   jax.random.PRNGKey(23), latency=jfed.LatencyPlan(base=0.7))
        else:
            st = fed.init_state(params_from_numpy(params, device=CPU))
            st, m = fed.run_rounds(st, {k: torch.from_numpy(v) for k, v in data.items()}, None,
                                   trandom.PRNGKey(23, device=CPU),
                                   latency=tfed.LatencyPlan(base=0.7))
        out.append((np.asarray(m["owner"]), np.asarray(m["timed_out"]), fed.reconcile(st)))
    (jo, jt, jl), (to, tt, tl) = out
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tt, jt)
    assert tt.any() and not tt.all()
    assert tl == jl


# ------------------------------- contracts inside the port ---------------------------
def _tensors(st):
    theta = st.theta_L
    out = [theta.buf] if isinstance(theta, tfed.ParamFlat) else tree_flatten(theta)[0]
    bank = st.bank
    out += ([bank.codes, bank.scales, bank.residual] if isinstance(bank, QuantBank)
            else tree_flatten(bank)[0])
    out += [st.step]
    for part in (st.faults, st.stale):
        out += [] if part is None else list(part)
    if st.tree is not None:
        out += tree_flatten(st.tree.nodes)[0] + [st.tree.counts]
    return out


@pytest.mark.parametrize("state", list(STATES))
def test_step_loop_equals_run_rounds_with_the_runtime(toy, state):
    params, data = toy
    f_run, s_run, m_run = _run(tfed, toy, state)
    codes = tfed.merge_timeout_codes(
        tfed.FaultPlan(**PLAN).draw(trandom.PRNGKey(8, device=CPU), K),
        tfed.LatencyPlan(**LATENCY).draw(trandom.PRNGKey(8, device=CPU), torch.from_numpy(SEQ)),
        RUNTIME["deadline"])
    keys = trandom.split(trandom.PRNGKey(8, device=CPU), K)
    fed = _fed(tfed, state)
    st = fed.init_state(params_from_numpy(params, device=CPU))
    for k in range(K):
        st, m = fed.step(st, {n: torch.from_numpy(v[k]) for n, v in data.items()}, int(SEQ[k]),
                         keys[k], fault_code=int(codes[k]))
        for name in ("refused", "dropped", "faulted", "quarantined", "timed_out", "retried"):
            assert m[name] == bool(m_run[name][k]), (k, name)
    for a, b in zip(_tensors(st), _tensors(s_run), strict=True):
        assert torch.equal(a, b)
    assert fed.ledger() == f_run.reconcile(s_run)


@pytest.mark.parametrize("state", list(STATES))
def test_default_policy_and_zero_plans_equal_the_fault_off_engine(toy, state):
    params, data = toy
    out = []
    for armed in (False, True):
        fed = _fed(tfed, state, staleness=dict() if armed else None,
                   fault_policy=None)
        assert (fed.fault_policy is not None) == armed      # auto-armed, never quarantines
        st = fed.init_state(params_from_numpy(params, device=CPU))
        extra = dict(faults=tfed.FaultPlan(), latency=tfed.LatencyPlan()) if armed else {}
        st, m = fed.run_rounds(st, {k: torch.from_numpy(v) for k, v in data.items()}, SEQ,
                               key=trandom.PRNGKey(4, device=CPU), **extra)
        out.append((st, m, fed.reconcile(st)))
    (s0, m0, l0), (s1, m1, l1) = out
    # the model, bank and step (the armed state carries its counters beside)
    n = len(_tensors(s0)) - (0 if s0.tree is None else 2)
    for a, b in zip(_tensors(s0)[:n], _tensors(s1)[:n]):
        assert torch.equal(a, b)
    if s0.tree is not None:
        assert torch.equal(s0.tree.nodes, s1.tree.nodes)
        assert torch.equal(s0.tree.counts, s1.tree.counts)
    for name in m0:
        assert torch.equal(m0[name], m1[name]), name
    assert l0 == l1


def test_reconcile_folds_the_runtime_columns_exactly(toy):
    tf, ts, _ = _run(tfed, toy, "f32")
    want = {c: _np(getattr(ts.ledger, c)).tolist() for c in ("timed_out", "retried")}
    led = tf.reconcile(ts)
    assert [led[i]["timed_out"] for i in range(N)] == want["timed_out"]
    assert [led[i]["retried"] for i in range(N)] == want["retried"]
    assert tf.reconcile(ts) == led                      # idempotent
    ts.ledger.retried[0] -= 1                           # a column went backwards
    with pytest.raises(LedgerDriftError, match="backwards"):
        tf.reconcile(ts)
    assert tf.ledger() == led                           # the accountant is untouched


# --------------------------------------- raising -------------------------------------
def _latency_without_staleness(toy):
    params, data = toy
    fed = _fed(tfed, "f32", staleness=None)
    st = fed.init_state(params_from_numpy(params, device=CPU))
    fed.run_rounds(st, {k: torch.from_numpy(v) for k, v in data.items()}, SEQ,
                   key=trandom.PRNGKey(0, device=CPU), latency=tfed.LatencyPlan(base=1.0))


def _staleness_without_faults(toy):
    fed = _fed(tfed, "f32")
    cfg = fed.as_async_config()
    init_state(params_from_numpy(toy[0], device=CPU),
               AsyncDPConfig(**{**cfg.__dict__, "fault_policy": None}), device=CPU)


def _times_length(toy):
    params, data = toy
    fed = _fed(tfed, "f32")
    st = fed.init_state(params_from_numpy(params, device=CPU))
    fed.run_rounds(st, {k: torch.from_numpy(v) for k, v in data.items()}, SEQ,
                   key=trandom.PRNGKey(0, device=CPU), latency=tfed.LatencyPlan(base=1.0),
                   times=np.linspace(0.0, 1.0, K - 1))


RAISING = {
    "latency without staleness": (_latency_without_staleness, "staleness-armed"),
    "staleness without the fault layer": (_staleness_without_faults, "fault"),
    "tick times of the wrong length": (_times_length, "tick times"),
}


@pytest.mark.parametrize("case", list(RAISING))
def test_raising_cases(toy, case):
    fn, match = RAISING[case]
    with pytest.raises(ValueError, match=match):
        fn(toy)
