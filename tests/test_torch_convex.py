"""The port's convex Algorithm 1 (repro_torch.federation.convex, linear,
clocks, schedules, owners; repro_torch.core.cop; repro_torch.data.synthetic)
against the reference, on the CPU at toy size.

Exact: the synthetic shards, the f64 sums of `make_problem` rounded to f32,
the Theorem-2 forecasts (numpy on both sides), every owner sequence
(uniform, Poisson, availability trace sampled and replayed; the draws are
integer streams, and the trace's window tests see times that agree), the
refusal pattern under a cap and the ledgers. Within tolerance: theta_L, the
bank and psi, rtol 1e-5 and atol 1e-5 (two f32 matrix-vector products in
other orders and Laplace draws within 1 ulp: the largest difference
measured at these sizes is 1.4e-6 on psi near 3); the Poisson times within
rtol 1e-6 (the exponential's log1p within 1 ulp, summed in jax's order).
Inside the port, replicas equal one-key runs and a refused step is a no-op,
bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federation as J
from repro.core import cop as jcop
from repro.data import synthetic as jsyn
from repro_torch import random as trandom
from repro_torch.core import cop as tcop
from repro_torch.data import synthetic as tsyn
import repro_torch.federation as T
from repro_torch.federation import clocks as tclocks
from repro_torch.federation import convex as tconvex

CPU = "cpu"
RTOL = ATOL = 1e-5
HORIZON, SIGMA = 120, 2e-5
WINDOWS = ((0.0, 0.5), (0.25, 0.75), (0.5, 1.0), (0.75, 0.25))
TRACE = (0, 1, 3, 2, 2, 1, 0)


def _np(t):
    return t.detach().cpu().numpy()


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=rtol, atol=atol)


def _ledger_parity(led_torch, led_jax):
    """The port's ledger equals the reference's on the port's keys; the
    reference's fault and staleness columns are all zero on these paths."""
    assert set(led_torch) == set(led_jax)
    for i, row in led_torch.items():
        jrow = led_jax[i]
        assert row == {k: jrow[k] for k in row}, i
        assert all(jrow[k] == 0 for k in set(jrow) - set(row)), i


def _keys(seed):
    return jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device=CPU)


@pytest.fixture(scope="module")
def problem():
    shards = tsyn.owner_shards("lending", [1500] * 4, seed=0)
    jprob, jown = J.federate_problem(shards, 2.0, reg=1e-5, theta_max=2.0)
    tprob, town = T.federate_problem(shards, 2.0, reg=1e-5, theta_max=2.0, device=CPU)
    return jprob, jown, tprob, town


# --------------------------------- data and cop ---------------------------------
@pytest.mark.parametrize("gen", ["lending", "health"])
@pytest.mark.parametrize("seed,p", [(0, 10), (5, 4)])
def test_generators_draw_the_reference_data(gen, seed, p):
    shift = np.linspace(-0.3, 0.3, p)
    for kw in ({}, {"theta_shift": shift}):
        X, y = getattr(tsyn, gen)(700, seed=seed, p=p, **kw)
        jX, jy = getattr(jsyn, gen)(700, seed=seed, p=p, **kw)
        assert np.array_equal(X, jX) and np.array_equal(y, jy)


@pytest.mark.parametrize("dataset", ["lending", "health"])
@pytest.mark.parametrize("heterogeneity", [0.0, 0.3])
def test_owner_shards_equal_the_reference(dataset, heterogeneity):
    sizes = [300, 500, 200]
    ours = tsyn.owner_shards(dataset, sizes, seed=2, heterogeneity=heterogeneity)
    ref = jsyn.owner_shards(dataset, sizes, seed=2, heterogeneity=heterogeneity)
    for (X, y), (jX, jy) in zip(ours, ref):
        assert np.array_equal(X, jX) and np.array_equal(y, jy)


def test_cop_forecasts_equal_the_reference():
    eps = [1.0, 2.5, 10.0]
    assert tcop.budget_sum(eps) == jcop.budget_sum(eps)
    assert tcop.bound_theorem2(1000, 3, 30_000, eps, 0.7, 3.0) == \
        jcop.bound_theorem2(1000, 3, 30_000, eps, 0.7, 3.0)
    assert tcop.bound_asymptotic(30_000, eps, 0.7, 3.0) == \
        jcop.bound_asymptotic(30_000, eps, 0.7, 3.0)
    rng = np.random.default_rng(0)
    ns = np.array([2, 5, 10, 25, 50] * 3, float) * 10_000
    sums = np.array([tcop.budget_sum([e] * int(n // 10_000)) for n, e in
                     zip(ns, np.repeat([1.0, 2.5, 10.0], 5))])
    # a fit with both constants positive, one whose c2 clips (refit c1), one
    # whose c1 clips (refit c2), and the unconstrained fit
    for observed, nonneg in ((0.5 * np.sqrt(sums) / ns + 40 * sums / ns ** 2, True),
                             (0.5 * np.sqrt(sums) / ns - 900 * sums / ns ** 2, True),
                             (-0.5 * np.sqrt(sums) / ns + 90 * sums / ns ** 2, True),
                             (rng.normal(size=ns.size) * 1e-4, False)):
        assert tcop.fit_constants(ns, sums, observed, nonneg) == \
            jcop.fit_constants(ns, sums, observed, nonneg)
    for psi_iso, c1, c2 in ((0.05, 30.0, 5e4), (0.2, 1.0, 1.0), (1e-9, 1e3, 1e9)):
        assert tcop.min_owners_for_benefit(psi_iso, 10_000, 1.0, c1, c2, max_n=300) == \
            jcop.min_owners_for_benefit(psi_iso, 10_000, 1.0, c1, c2, max_n=300)


# ------------------------------- the problem ----------------------------------
def test_make_problem_and_federate_problem_match_the_reference(problem):
    jprob, jown, tprob, town = problem
    for f in ("G", "h", "c", "theta_star", "f_star"):
        t = getattr(tprob, f)
        assert t.dtype == torch.float32 and t.device.type == CPU
        np.testing.assert_array_equal(_np(t), np.asarray(getattr(jprob, f)))
    assert (tprob.reg, tprob.theta_max, tprob.n_total, tprob.xi) == \
        (jprob.reg, jprob.theta_max, jprob.n_total, jprob.xi)
    for o, jo in zip(town, jown):
        assert (o.n, o.epsilon, o.xi) == (jo.n, jo.epsilon, jo.xi)
        np.testing.assert_array_equal(_np(o.gram.A), np.asarray(jo.gram.A))
        np.testing.assert_array_equal(_np(o.gram.b), np.asarray(jo.gram.b))
    X, y = tsyn.lending(400, seed=9)
    ours = T.DataOwner.from_arrays(X, y, 3.0, theta_max=2.0, device=CPU)
    ref = J.DataOwner.from_arrays(X, y, 3.0, theta_max=2.0)
    assert (ours.n, ours.epsilon, ours.xi) == (ref.n, ref.epsilon, ref.xi)
    np.testing.assert_array_equal(_np(ours.gram.A), np.asarray(ref.gram.A))
    with pytest.raises(AssertionError, match="theta_max too small"):
        T.make_problem(tsyn.owner_shards("lending", [500] * 2), theta_max=0.01, device=CPU)


def test_fitness_functions_match_the_reference(problem):
    jprob, jown, tprob, town = problem
    theta = np.random.default_rng(4).normal(size=(5, 10)).astype(np.float32)
    for th in theta:
        _close(T.fitness(tprob, torch.from_numpy(th)), J.fitness(jprob, jnp.asarray(th)))
        _close(T.relative_fitness(tprob, torch.from_numpy(th)),
               J.relative_fitness(jprob, jnp.asarray(th)))
        _close(T.owner_grad(town[1].gram, torch.from_numpy(th)),
               J.owner_grad(jown[1].gram, jnp.asarray(th)))
    # a batch of thetas gives what each gives alone
    batched = T.relative_fitness(tprob, torch.from_numpy(theta))
    assert torch.equal(batched, torch.stack([T.relative_fitness(tprob, torch.from_numpy(t))
                                             for t in theta]))
    assert float(T.relative_fitness(tprob, tprob.theta_star)) == pytest.approx(0.0, abs=1e-5)


def test_budgets_broadcast_and_renegotiate(problem):
    _, jown, _, town = problem
    for mod, owners in ((T, town), (J, jown)):
        re = mod.with_budgets(owners, 7.0)
        assert [o.epsilon for o in re] == [7.0] * 4 and [o.n for o in re] == [o.n for o in owners]
        assert [o.epsilon for o in mod.with_budgets(owners, [1, 2, 3, 4])] == [1.0, 2.0, 3.0, 4.0]
        with pytest.raises(ValueError, match="2 budgets for 4 owners"):
            mod.with_budgets(owners, [1.0, 2.0])


# -------------------------------- the schedules ---------------------------------
def test_cumsum_takes_jax_order():
    for n in (1, 16, 17, 200, 1000, 4097):
        x = np.asarray(jax.random.exponential(jax.random.PRNGKey(n), (2, n))) / np.float32(7)
        np.testing.assert_array_equal(_np(tclocks._cumsum(torch.from_numpy(x))),
                                      np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)))


@pytest.mark.parametrize("seed", [0, 3])
def test_clocks_match_the_reference(seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(_np(T.uniform_schedule(tk, 7, 300)),
                                  np.asarray(J.uniform_schedule(jk, 7, 300)))
    ours, ref = T.poisson_schedule(tk, 7, 300, 2.0), J.poisson_schedule(jk, 7, 300, 2.0)
    np.testing.assert_array_equal(_np(ours.owners), np.asarray(ref.owners))
    _close(ours.times, ref.times, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(_np(T.owner_counts(ours.owners, 7)),
                                  np.asarray(J.owner_counts(ref.owners, 7)))


def _schedules(mod):
    return {"uniform": mod.UniformSchedule(), "poisson": mod.PoissonSchedule(rate=0.5),
            "availability": mod.AvailabilityTraceSchedule(windows=WINDOWS, period=3.0),
            "replay": mod.AvailabilityTraceSchedule(windows=WINDOWS, trace=TRACE)}


@pytest.mark.parametrize("name", ["uniform", "poisson", "availability", "replay"])
def test_schedules_draw_the_reference_sequence_also_batched(name):
    ours, ref = _schedules(T)[name], _schedules(J)[name]
    assert isinstance(ours, T.ScheduleProtocol)
    jk, tk = _keys(11)
    np.testing.assert_array_equal(_np(ours.draw(tk, 4, 500)), np.asarray(ref.draw(jk, 4, 500)))
    jks, tks = jax.random.split(jk, 3), trandom.split(tk, 3)
    drawn = ours.draw(tks, 4, 500)
    assert drawn.shape == (3, 500) and drawn.dtype == torch.int32
    np.testing.assert_array_equal(_np(drawn), np.asarray(jax.vmap(
        lambda k: ref.draw(k, 4, 500))(jks)))


def test_availability_masks_match_the_reference():
    ours, ref = _schedules(T)["availability"], _schedules(J)["availability"]
    jk, tk = _keys(5)
    times = ref.draw_with_times(jk, 4, 600).times
    for fallback in (False, True):
        np.testing.assert_array_equal(
            _np(ours.available(torch.from_numpy(np.array(times)), fallback=fallback)),
            np.asarray(ref.available(times, fallback=fallback)))
    # a gap in the windows: the draw falls back to everyone
    gap = T.AvailabilityTraceSchedule(windows=((0.0, 0.4), (0.1, 0.4)), period=3.0)
    drawn = gap.draw_with_times(tk, 2, 2000)
    raw, eff = _np(gap.available(drawn.times)), _np(gap.available(drawn.times, fallback=True))
    owners = _np(drawn.owners)
    assert not raw.any(axis=1).all() and eff[np.arange(owners.size), owners].all()
    assert eff[~raw.any(axis=1)].all()


def test_trace_replay_checks_caches_and_rejects_the_ring():
    with pytest.raises(ValueError, match="out of range"):
        T.AvailabilityTraceSchedule(windows=WINDOWS, trace=(0, 4))
    with pytest.raises(ValueError, match="empty trace"):
        T.AvailabilityTraceSchedule(windows=WINDOWS, trace=())
    sched = _schedules(T)["replay"]
    tk = trandom.PRNGKey(0, device=CPU)
    first = sched._tiled(20, tk.device)
    assert sched._tiled(20, tk.device) is first and first.tolist() == list(np.resize(TRACE, 20))
    assert sched == _schedules(T)["replay"]             # the cache is not a field
    with pytest.raises(ValueError, match="4 windows for 3 owners"):
        sched.draw(tk, 3, 10)
    with pytest.raises(NotImplementedError, match="paged owner bank"):
        sched.trace_ring()


# ------------------------------- the convex engine --------------------------------
def _engine_args(problem, mod):
    jprob, jown, tprob, town = problem
    if mod is J:
        A, b, n_i = J.stack_gram([o.gram for o in jown])
        return jprob, A, b, n_i, J.PaperMechanism(jown, J.FederationConfig(
            horizon=HORIZON, sigma=SIGMA)).scales()
    A, b, n_i = T.stack_gram([o.gram for o in town])
    return tprob, A, b, n_i, T.PaperMechanism(town, T.FederationConfig(
        horizon=HORIZON, sigma=SIGMA)).scales(device=CPU)


@pytest.mark.parametrize("cap", [None, 20])
@pytest.mark.parametrize("seed", [0, 1])
def test_scan_engine_matches_the_reference(problem, cap, seed):
    kw = dict(horizon=HORIZON, rho=1.0, sigma=SIGMA, lr_scale=1.3, cap=cap)
    jk, tk = _keys(seed)
    ref = J.scan_engine(jk, *_engine_args(problem, J), **kw)
    ours = T.scan_engine(tk, *_engine_args(problem, T), **kw)
    np.testing.assert_array_equal(_np(ours.owners_seq), np.asarray(ref.owners_seq))
    _close(ours.theta_L, ref.theta_L)
    _close(ours.theta_bank, ref.theta_bank)
    _close(ours.psi, ref.psi)
    assert ours.psi.shape == (HORIZON,) and ours.theta_bank.shape == (4, 10)


def test_refused_steps_are_bit_exact_no_ops(problem):
    prob, A, b, n_i, scales = _engine_args(problem, T)
    keys = trandom.split(trandom.PRNGKey(2, device=CPU), 2)
    owners, noise = tconvex._draws(keys, 4, 10, HORIZON, scales, None)
    cap = 15
    theta_L = torch.zeros((2, 10))
    bank, counts = torch.zeros((2, 4, 10)), torch.zeros((2, 4), dtype=torch.int32)
    seen = np.zeros((2, 4), int)
    refused = 0
    prev_L, prev_bank = theta_L.clone(), bank.clone()
    for k, (theta_L, bank) in enumerate(tconvex._steps(
            prob, A, b, n_i, owners, noise, theta_L, bank, counts, rho=1.0, sigma=SIGMA,
            lr_scale=1.0, cap=cap)):
        for r in range(2):
            i = int(owners[r, k])
            if seen[r, i] >= cap:
                refused += 1
                assert torch.equal(theta_L[r], prev_L[r]) and torch.equal(bank[r], prev_bank[r])
            else:
                assert not torch.equal(bank[r, i], prev_bank[r, i])
            seen[r, i] += 1
        prev_L, prev_bank = theta_L.clone(), bank.clone()
    assert refused > 0
    assert counts.tolist() == np.minimum(seen, cap).tolist()


def test_sync_scan_engine_matches_the_reference(problem):
    jk, tk = _keys(4)
    ref = J.sync_scan_engine(jk, *_engine_args(problem, J), horizon=HORIZON, lr=0.4)
    ours = T.sync_scan_engine(tk, *_engine_args(problem, T), horizon=HORIZON, lr=0.4)
    _close(ours.theta_L, ref.theta_L)
    _close(ours.psi, ref.psi)


@pytest.mark.parametrize("composition", ["paper", "per_owner_rounds"])
def test_run_many_matches_the_reference_and_one_key_runs(problem, composition):
    jprob, jown, tprob, town = problem
    kw = dict(horizon=HORIZON, rho=1.0, sigma=SIGMA, epsilons=[2.0, 1.0, 4.0, 2.0],
              composition=composition)
    ref = J.run_many(jax.random.PRNGKey(3), jprob, [o.gram for o in jown],
                     J.Algo1Config(**kw), 3)
    key = trandom.PRNGKey(3, device=CPU)
    ours = T.run_many(key, tprob, [o.gram for o in town], T.Algo1Config(**kw), 3)
    np.testing.assert_array_equal(_np(ours.owners_seq), np.asarray(ref.owners_seq))
    for f in ("theta_L", "theta_bank", "psi"):
        _close(getattr(ours, f), getattr(ref, f))
    for r, k in enumerate(trandom.split(key, 3)):
        one = T.run_algorithm1(k, tprob, [o.gram for o in town], T.Algo1Config(**kw))
        for f in one._fields:
            assert torch.equal(getattr(one, f), getattr(ours, f)[r])


# ---------------------------------- the session ----------------------------------
def _feds(problem, **kw):
    jprob, jown, tprob, town = problem
    cfg = dict(horizon=HORIZON, rho=1.0, sigma=SIGMA)
    tkw = dict(kw)
    if "schedule" in kw:
        tkw["schedule"] = _schedules(T)[kw["schedule"]]
        kw = dict(kw, schedule=_schedules(J)[kw["schedule"]])
    return (J.Federation(jown, J.FederationConfig(**cfg), **kw),
            T.Federation(town, T.FederationConfig(**cfg), device=CPU, **tkw))


@pytest.mark.parametrize("schedule", ["uniform", "poisson", "availability", "replay"])
@pytest.mark.parametrize("mechanism", ["paper", "per_owner_rounds"])
def test_ledgered_run_matches_the_reference(problem, schedule, mechanism):
    jprob, _, tprob, _ = problem
    jf, tf = _feds(problem, schedule=schedule, mechanism=mechanism)
    ref = jf.run(jax.random.PRNGKey(6), jprob)
    ours = tf.run(trandom.PRNGKey(6, device=CPU), tprob)
    np.testing.assert_array_equal(_np(ours.owners_seq), np.asarray(ref.owners_seq))
    for f in ("theta_L", "theta_bank", "psi"):
        _close(getattr(ours, f), getattr(ref, f))
    _ledger_parity(tf.ledger(), jf.ledger())
    counts = np.bincount(_np(ours.owners_seq), minlength=4)
    led = tf.ledger()
    cap = tf.mechanism.cap or HORIZON
    assert [led[i]["responses"] for i in range(4)] == np.minimum(counts, cap).tolist()
    assert [led[i]["refused"] for i in range(4)] == np.maximum(counts - cap, 0).tolist()


def test_replicas_match_the_reference_and_are_not_ledgered(problem):
    jprob, _, tprob, _ = problem
    jf, tf = _feds(problem, schedule="poisson")
    ref = jf.run(jax.random.PRNGKey(7), jprob, n_runs=3)
    ours = tf.run(trandom.PRNGKey(7, device=CPU), tprob, n_runs=3)
    np.testing.assert_array_equal(_np(ours.owners_seq), np.asarray(ref.owners_seq))
    _close(ours.psi, ref.psi)
    assert all(r["responses"] == 0 for r in tf.ledger().values())
    tf.run(trandom.PRNGKey(8, device=CPU), tprob, n_runs=2)     # replicas are reusable


def test_run_sync_matches_the_reference_and_charges_every_owner(problem):
    jprob, _, tprob, _ = problem
    for n_runs in (None, 2):
        jf, tf = _feds(problem, strategy="sync")
        ref = jf.run_sync(jax.random.PRNGKey(9), jprob, lr=0.4, n_runs=n_runs)
        ours = tf.run_sync(trandom.PRNGKey(9, device=CPU), tprob, lr=0.4, n_runs=n_runs)
        _close(ours.theta_L, ref.theta_L)
        _close(ours.psi, ref.psi)
        _ledger_parity(tf.ledger(), jf.ledger())
        expected = HORIZON if n_runs is None else 0
        assert all(r["responses"] == expected for r in tf.ledger().values())


def test_strict_mechanism_scales_by_sqrt_p(problem):
    jprob, jown, tprob, town = problem
    cfg = T.FederationConfig(horizon=HORIZON, sigma=SIGMA)
    paper = T.PaperMechanism(town, cfg).scales(device=CPU)
    strict = T.StrictMechanism(town, cfg).scales(p=16, device=CPU)
    np.testing.assert_allclose(_np(strict), 4.0 * _np(paper), rtol=1e-6)
    np.testing.assert_array_equal(_np(strict), np.asarray(J.StrictMechanism(
        jown, J.FederationConfig(horizon=HORIZON, sigma=SIGMA)).scales(p=16)))
    with pytest.raises(ValueError, match="dimension p"):
        T.StrictMechanism(town, cfg).scales(device=CPU)
    assert T.laplace_scale_theorem1(1.0, 10, 5, 2.0, p=9, l1_slack="strict") == \
        J.laplace_scale_theorem1(1.0, 10, 5, 2.0, p=9, l1_slack="strict")
    with pytest.raises(ValueError):
        T.laplace_scale_theorem1(1.0, 10, 5, 2.0, l1_slack="loose")
    jf, tf = _feds(problem, mechanism="strict")
    ref = jf.run(jax.random.PRNGKey(1), jprob)
    ours = tf.run(trandom.PRNGKey(1, device=CPU), tprob)
    _close(ours.psi, ref.psi)
    _ledger_parity(tf.ledger(), jf.ledger())


def test_noiseless_runs_match_the_reference(problem):
    jprob, jown, tprob, town = problem
    cfg = dict(horizon=HORIZON, rho=1.0, sigma=SIGMA, noiseless=True)
    ref = J.Federation(jown, J.FederationConfig(**cfg)).run(jax.random.PRNGKey(0), jprob)
    ours = T.Federation(town, T.FederationConfig(**cfg), device=CPU).run(
        trandom.PRNGKey(0, device=CPU), tprob)
    _close(ours.psi, ref.psi)
    assert float(ours.psi[-1]) < float(ours.psi[9])


def test_the_convex_session_raises_where_the_reference_raises(problem):
    jprob, jown, tprob, town = problem
    key = trandom.PRNGKey(0, device=CPU)
    cfg = T.FederationConfig(horizon=20, sigma=SIGMA)
    fed = T.Federation(town, cfg, device=CPU)
    fed.run(key, tprob)
    with pytest.raises(RuntimeError, match="already ran"):
        fed.run(key, tprob)
    with pytest.raises(ValueError, match="tree mechanism"):
        T.Federation(town, cfg, mechanism="tree", tree_depth=3, device=CPU).run(key, tprob)
    with pytest.raises(ValueError, match="tree mechanism"):
        T.Federation(town, cfg, mechanism="tree", strategy="sync",
                     device=CPU).run_sync(key, tprob, lr=0.4)
    with pytest.raises(ValueError, match="asynchronous composition"):
        T.Federation(town, cfg, mechanism="per_owner_rounds", strategy="sync",
                     device=CPU).run_sync(key, tprob, lr=0.4)
    sync = T.Federation(town, cfg, strategy="sync", device=CPU)
    with pytest.raises(ValueError, match="async path"):
        sync.run(key, tprob)
    with pytest.raises(ValueError, match="strategy='sync'"):
        fed.run_sync(key, tprob, lr=0.4)
    with pytest.raises(ValueError, match="strategy must be one of"):
        T.Federation(town, cfg, strategy="semi", device=CPU)
    with pytest.raises(ValueError, match="Gram payloads"):
        T.Federation([dataclasses.replace(o, gram=None) for o in town], cfg,
                     device=CPU).run(key, tprob)
    with pytest.raises(ValueError, match="unknown mechanism"):
        T.Federation(town, cfg, mechanism="loose", device=CPU)


@pytest.mark.parametrize("entry", ["make_problem", "federate_problem", "from_arrays",
                                   "Federation(strategy='sync')"])
def test_convex_entry_points_without_device_raise_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    shards = tsyn.owner_shards("lending", [100] * 2)
    calls = {
        "make_problem": lambda: T.make_problem(shards, theta_max=2.0),
        "federate_problem": lambda: T.federate_problem(shards, 1.0, theta_max=2.0),
        "from_arrays": lambda: T.DataOwner.from_arrays(*shards[0], 1.0, theta_max=2.0),
        "Federation(strategy='sync')": lambda: T.Federation(
            [T.DataOwner(n=100, epsilon=1.0, xi=1.0)], T.FederationConfig(horizon=3),
            strategy="sync"),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
