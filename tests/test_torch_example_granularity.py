"""Per-example clipping on the port's fused flat engine, against the reference.

Both packages run `make_step(..., pack_params=True,
privatizer=PrivatizerConfig(granularity="example", fused_kernel=True))` on
the same weights, batches, owner sequence and keys (made from a seed with
numpy): the reference's flat-engine tests all run at this granularity
(test_fused_rounds.py, test_flatten.py, test_faults.py, test_quant_bank.py,
test_paged_bank.py, test_checkpoint.py, test_tree_mechanism.py,
test_staleness.py). Each example's gradient is taken at theta_bar with the
example as a batch of one and clipped by its own norm; the port computes
the B norms of a round (g*B of a group) in one `sqnorm` row-axis launch.

Across packages, exact: owner sequences, refusal and fault masks, leaf
counts and the reconciled ledger (integer streams and host logic); the
clip fractions (a norm within rounding of xi would flip one, none does
here). To a tolerance: theta_L, f32 banks and tree nodes within rtol 1e-4
and 1e-5 of the largest magnitude (two autodiff systems, other summation
orders, log1p against log1pf, cancelling noisy updates); the clip norms
within rtol 1e-5; a bf16 bank within one bf16
step (2^-7 relative), an f16 bank within one f16 step (2^-10); int8 and
fp8 codes within one code, where an ulp flipped a stochastic rounding.
Inside the port, bit for bit: the step loop equals `run_rounds` (with
exhaustion and with fault codes), a refused round is a no-op, the paged
engine equals the flat one, `pre_grouped` is ignored, and a restored
checkpoint resumes as the uninterrupted run.

Model leaves in f32, bf16 and f16 ("mixed") pack exactly into the f32
buffer in both packages and train on the fused engine; `params_of` gives
them back in their dtypes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import repro.federation as jfed
import repro_torch.federation as tfed
from repro.checkpoint.store import _flatten_with_paths
from repro_torch import random as trandom
from repro_torch.checkpoint import flatten_with_paths
from repro_torch.checkpoint.store import to_storage
from repro_torch.convert import (device_ledger_from_numpy, flat_spec_from_numpy,
                                 flat_state_from_numpy, params_from_numpy, quant_bank_from_numpy,
                                 tree_noise_from_numpy)
from repro_torch.federation import QuantBank
from repro_torch.federation import deep as tdeep

CPU = "cpu"
N, K, B = 8, 24, 4
XI = 4.0                     # most examples clip, some do not
RTOL, ATOL = 1e-4, 1e-6
# fault codes of the fault-armed cases (OK, DROP, STALE, NONFINITE, CORRUPT)
CODES = np.array([0, 0, 3, 0, 4, 0, 0, 2, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 4, 0, 0, 3, 0, 0],
                 np.int8)
LATENCY = np.random.default_rng(5).uniform(0.2, 1.6, K).astype(np.float32)

# case: the options of its federation
STATES = {
    "f32": dict(),
    "bf16": dict(bank="bfloat16"),
    "f16": dict(bank="float16"),
    "int8": dict(bank="int8"),
    "fp8": dict(bank="fp8"),
    "tree": dict(tree=2),
    "faults": dict(faults=True),
    "staleness": dict(faults=True, staleness=True),
    "mixed": dict(mixed=True),
    "mixed-f16": dict(mixed=True, bank="float16"),
    "mixed-int8-tree": dict(mixed=True, bank="int8", tree=2),
    "unfused": dict(fused=False),
}
DRIVERS = ("sequential", "grouped")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(mixed=False):
    rng = np.random.default_rng(11)
    params = {"w": rng.standard_normal((6, 3)).astype(np.float32),
              "b": (0.1 * rng.standard_normal(3)).astype(np.float32)}
    if mixed:
        params = {"w": params["w"].astype(ml_dtypes.bfloat16),
                  "b": params["b"].astype(np.float16),
                  "s": rng.standard_normal(2).astype(np.float32)}
    data = {"x": rng.standard_normal((K, B, 6)).astype(np.float32),
            "y": rng.standard_normal((K, B, 3)).astype(np.float32)}
    seq = rng.integers(0, N, K).astype(np.int32)
    return params, data, seq


def _loss(mod, mixed):
    if mod is jfed:
        def loss(p, b):
            out = b["x"] @ p["w"].astype(jnp.float32) + p["b"].astype(jnp.float32)
            extra = 1e-2 * jnp.sum(p["s"] ** 2) if mixed else 0.0
            return jnp.mean((out - b["y"]) ** 2) + extra
    else:
        def loss(p, b):
            out = b["x"] @ p["w"].float() + p["b"].float()
            extra = 1e-2 * torch.sum(p["s"] ** 2) if mixed else 0.0
            return torch.mean((out - b["y"]) ** 2) + extra
    return loss


def _fed(mod, case, horizon=3, pre_grouped=False):
    o = STATES[case]
    kw = {}
    if o.get("tree"):
        kw.update(mechanism="tree", tree_depth=o["tree"])
    if o.get("faults"):
        kw["fault_policy"] = mod.FaultPolicy(max_faults=2, window=8)
    if o.get("staleness"):
        kw["staleness"] = mod.StalenessPolicy(deadline=1.0, max_retries=2, decay=0.9)
    if mod is tfed:
        kw["device"] = CPU
    fed = mod.Federation([mod.DataOwner(n=2000 * (1 + i % 3), epsilon=1.0, xi=1.0)
                          for i in range(N)],
                         mod.FederationConfig(horizon=horizon, sigma=1e-2, theta_max=10.0,
                                              lr_scale=5.0), **kw)
    priv = mod.PrivatizerConfig(xi=XI, granularity="example",
                                fused_kernel=o.get("fused", True), pre_grouped=pre_grouped)
    fed.make_step(_loss(mod, o.get("mixed", False)), privatizer=priv, pack_params=True,
                  bank_dtype=o.get("bank"))
    return fed


def _params(mod, params):
    if mod is jfed:
        return {k: jnp.asarray(v) for k, v in params.items()}
    return params_from_numpy(params, device=CPU)


def _batches(mod, data, sl=slice(None)):
    if mod is jfed:
        return {k: jnp.asarray(v[sl]) for k, v in data.items()}
    return {k: torch.from_numpy(v[sl].copy()) for k, v in data.items()}


def _key(mod, seed):
    return jax.random.PRNGKey(seed) if mod is jfed else trandom.PRNGKey(seed, device=CPU)


def _extras(mod, case, sl=slice(None)):
    o = STATES[case]
    kw = {}
    if o.get("faults"):
        kw["faults"] = CODES[sl] if mod is jfed else torch.from_numpy(CODES[sl])
    if o.get("staleness"):
        kw["latency"] = LATENCY[sl]
    return kw


def _run(mod, case, driver, horizon=3):
    params, data, seq = _toy(STATES[case].get("mixed", False))
    fed = _fed(mod, case, horizon)
    st = fed.init_state(_params(mod, params))
    st, ms = fed.run_rounds(st, _batches(mod, data), seq if mod is tfed else jnp.asarray(seq),
                            key=_key(mod, 4), owner_parallel=driver == "grouped",
                            **_extras(mod, case))
    return fed, st, ms


def _f32(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "f" or x.dtype.name == "bfloat16" else x


def _bits(x):
    """The raw bytes of a tensor or array (bf16 and fp8 included)."""
    a = to_storage(x)[0] if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _close(got, want, rtol=RTOL):
    """Within rtol of each value and 1e-5 of the array's largest magnitude
    (noisy updates cancel: a value far below the clip range carries the
    rounding of the terms it came from)."""
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=max(ATOL, 1e-5 * float(np.abs(want).max(initial=0.0))))


def _ledger_parity(got, want):
    assert set(got) == set(want)
    for i, row in got.items():
        assert row == {k: want[i][k] for k in row}, i


def _bank_close(tbank, jbank, case):
    bank = STATES[case].get("bank")
    if bank in ("int8", "fp8"):
        codes_t, codes_j = tbank.codes.numpy(), np.asarray(jbank.codes)
        if bank == "int8":
            assert np.abs(codes_t.astype(np.int64) - codes_j.astype(np.int64)).max() <= 1
        else:                      # fp8 patterns: a step is one unit of the pattern
            assert np.abs(codes_t.view(np.uint8).astype(np.int64)
                          - codes_j.view(np.uint8).astype(np.int64)).max() <= 1
        np.testing.assert_allclose(tbank.scales.numpy(), np.asarray(jbank.scales), rtol=1e-4)
        return
    _close(tbank, jbank, {"bfloat16": 2 ** -7, "float16": 2 ** -10}.get(bank, RTOL))


# ------------------------------- the reference's results -----------------------------------
REF_CASES = [(s, d) for s in STATES for d in DRIVERS]


@pytest.mark.parametrize("case,driver", REF_CASES, ids=[f"{s}-{d}" for s, d in REF_CASES])
def test_run_rounds_matches_the_reference(case, driver):
    tf, ts, tm = _run(tfed, case, driver)
    jf, js, jm = _run(jfed, case, driver)
    for name in jm:
        got, want = _f32(tm[name]), _f32(jm[name])
        if name in ("max_grad_norm", "grad_noise_scale"):
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert 0.0 < float(np.mean(_f32(tm["clip_frac"]))) < 1.0     # both branches of the clip
    assert bool(_f32(tm["refused"]).any())                          # exhaustion bites
    _ledger_parity(tf.reconcile(ts), jf.reconcile(js))
    assert int(ts.step) == int(js.step)
    _close(ts.theta_L.buf, js.theta_L.buf)
    _bank_close(ts.bank, js.bank, case)
    if ts.tree is not None:
        np.testing.assert_array_equal(_f32(ts.tree.counts), _f32(js.tree.counts))
        _close(ts.tree.nodes, js.tree.nodes)
    if ts.faults is not None:
        # the windows and flags exactly (the checksums hash bank bits, which
        # agree to the tolerance only)
        for a, b in zip(ts.faults[1:], js.faults[1:]):
            np.testing.assert_array_equal(_f32(a), _f32(b))
    for a, b in zip(ts.stale or (), js.stale or ()):
        np.testing.assert_array_equal(_f32(a), _f32(b))
    # the model comes back in its leaves' dtypes, as the reference's
    tp, jp = tf.params_of(ts), jf.params_of(js)
    for k in jp:
        assert str(tp[k].dtype).replace("torch.", "") == np.dtype(jp[k].dtype).name, k
        _close(tp[k], jp[k], {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}.get(
            tp[k].dtype, RTOL))


# ------------------------------ the port's own contracts -----------------------------------
LOOP_CASES = ("f32", "bf16", "f16", "int8", "fp8", "tree", "faults", "mixed", "mixed-f16",
              "unfused")


def _state_bits(st):
    return {k: (str(v.dtype), _bits(v).copy()) for k, v in flatten_with_paths(st).items()}


def _assert_bits_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k][0] == b[k][0] and np.array_equal(a[k][1], b[k][1]), k


@pytest.mark.parametrize("case", LOOP_CASES)
def test_step_loop_equals_run_rounds_bit_for_bit(case):
    """With exhaustion (horizon 3 over 24 rounds of 8 owners), and on the
    fault-armed state with the same codes injected one round at a time."""
    params, data, seq = _toy(STATES[case].get("mixed", False))
    root = _key(tfed, 4)
    keys = trandom.split(root, K)
    fa = _fed(tfed, case)
    sa = fa.init_state(_params(tfed, params))
    faults = STATES[case].get("faults", False)
    refused = []
    for k in range(K):
        sa, m = fa.step(sa, _batches(tfed, data, k), int(seq[k]), keys[k],
                        fault_code=int(CODES[k]) if faults else None)
        refused.append(bool(m["refused"]))
    fb = _fed(tfed, case)
    sb, mb = fb.run_rounds(fb.init_state(_params(tfed, params)), _batches(tfed, data), seq,
                           key=root, **_extras(tfed, case))
    assert refused == [bool(r) for r in mb["refused"]] and any(refused)
    _assert_bits_equal(_state_bits(sa._replace(ledger=None)), _state_bits(sb._replace(ledger=None)))
    assert fa.reconcile(sa) == fb.reconcile(sb)


@pytest.mark.parametrize("case", ("f32", "f16", "int8", "tree", "mixed"))
def test_refused_round_is_a_bit_exact_no_op(case):
    params, data, _ = _toy(STATES[case].get("mixed", False))
    fed = _fed(tfed, case)
    st, _ = fed.run_rounds(fed.init_state(_params(tfed, params)), _batches(tfed, data, slice(3)),
                           np.zeros(3, np.int32), key=_key(tfed, 1))      # owner 0's cap
    before = _state_bits(st._replace(ledger=None))
    st, ms = fed.run_rounds(st, _batches(tfed, data, slice(3, 5)), np.zeros(2, np.int32),
                            key=_key(tfed, 2))
    assert bool(ms["refused"].all())
    _assert_bits_equal(_state_bits(st._replace(ledger=None)), before)
    assert fed.reconcile(st)[0]["refused"] == 2


def test_pre_grouped_is_ignored_per_example():
    """As the reference: per example, the batch's leading axis is the
    examples whatever `pre_grouped` says."""
    params, data, seq = _toy()
    out = []
    for pre in (False, True):
        fed = _fed(tfed, "f32", pre_grouped=pre)
        st, _ = fed.run_rounds(fed.init_state(_params(tfed, params)), _batches(tfed, data), seq,
                               key=_key(tfed, 4))
        out.append(st)
    _assert_bits_equal(_state_bits(out[0]._replace(ledger=None)),
                       _state_bits(out[1]._replace(ledger=None)))


@pytest.mark.parametrize("driver", DRIVERS)
def test_one_sqnorm_row_launch_per_round_or_group(monkeypatch, driver):
    """The per-example norms take one `fused_sqnorm_rows` call a round
    (B rows) on the sequential driver and one a group (g*B rows) on the
    grouped one, and no single-row `fused_sqnorm`."""
    calls = {"rows": [], "single": 0}
    rows, single = tdeep.fused_sqnorm_rows, tdeep.fused_sqnorm

    def count_rows(g):
        calls["rows"].append(g.shape[0])
        return rows(g)

    def count_single(g):
        calls["single"] += 1
        return single(g)

    monkeypatch.setattr(tdeep, "fused_sqnorm_rows", count_rows)
    monkeypatch.setattr(tdeep, "fused_sqnorm", count_single)
    params, data, seq = _toy()
    fed = _fed(tfed, "f32", horizon=K)
    fed.run_rounds(fed.init_state(_params(tfed, params)), _batches(tfed, data), seq,
                   key=_key(tfed, 4), owner_parallel=driver == "grouped", max_group=None)
    assert calls["single"] == 0
    if driver == "sequential":
        assert calls["rows"] == [B] * K
    else:
        groups = tfed.partition_conflict_free(seq, None)
        assert calls["rows"] == [B * length for _, length in groups] and len(groups) < K


def test_example_group_cap_plans_for_the_per_example_rows():
    """A member is planned at (2B + 6) rows of P f32 within 0.85 of the
    free bytes, and the cap never falls under one member."""
    per_member = (2 * B + 6) * 1000 * 4
    assert tdeep.example_group_cap(B, 1000, 0) == 1
    assert tdeep.example_group_cap(B, 1000, per_member) == 1
    assert tdeep.example_group_cap(B, 1000, 100 * per_member) == 85
    assert tdeep.example_group_cap(2 * B, 1000, 100 * per_member) < 85
    assert tdeep.device_free_bytes(CPU) is None


@pytest.mark.parametrize("cap", (1, 2))
def test_auto_groups_fit_the_free_device_memory(monkeypatch, cap):
    """Under max_group="auto", a device whose free memory holds `cap`
    members (example_group_cap) gets groups of at most `cap` rounds: one
    sqnorm over at most cap * B rows a group, and the run equals the one
    with max_group=min(auto, cap) bit for bit (cap 1: the sequential
    driver's)."""
    from repro_torch.federation import session as tsession
    params, data, seq = _toy()
    p = sum(np.asarray(v).size for v in params.values())
    per_member = (2 * B + 6) * p * 4
    monkeypatch.setattr(tsession, "device_free_bytes",
                        lambda device: int((cap + 0.5) * per_member / tdeep.EXAMPLE_MEMORY_SHARE))
    auto = tfed.auto_max_group(seq)
    assert auto > cap
    rows, calls = tdeep.fused_sqnorm_rows, []

    def count_rows(g):
        calls.append(g.shape[0])
        return rows(g)
    monkeypatch.setattr(tdeep, "fused_sqnorm_rows", count_rows)
    out = []
    for max_group in ("auto", min(auto, cap)):
        calls.clear()
        fed = _fed(tfed, "f32", horizon=K)
        st, _ = fed.run_rounds(fed.init_state(_params(tfed, params)), _batches(tfed, data), seq,
                               key=_key(tfed, 4), owner_parallel=True, max_group=max_group)
        out.append((_state_bits(st._replace(ledger=None)), list(calls)))
    groups = tfed.partition_conflict_free(seq, min(auto, cap))
    assert out[0][1] == out[1][1] == [B * length for _, length in groups]
    assert max(out[0][1]) <= cap * B
    _assert_bits_equal(out[0][0], out[1][0])


# ------------------------------------- paged -----------------------------------------------
PAGED_CASES = [(s, d) for s in ("f32", "f16", "int8", "tree", "mixed") for d in DRIVERS]


@pytest.mark.parametrize("case,driver", PAGED_CASES, ids=[f"{s}-{d}" for s, d in PAGED_CASES])
def test_paged_engine_equals_the_flat_one_bit_for_bit(case, driver):
    """n_hot 4 of 8 owners, dispatches of 4 rounds (rows evicted and
    reloaded between them) against the flat engine on the same dispatches."""
    params, data, seq = _toy(STATES[case].get("mixed", False))
    out = []
    for paged in (True, False):
        fed = _fed(tfed, case, horizon=4)
        p = _params(tfed, params)
        st = fed.init_paged_state(p, n_hot=4) if paged else fed.init_state(p)
        mets = []
        for d in range(K // 4):
            sl = slice(4 * d, 4 * d + 4)
            st, m = fed.run_rounds(st, _batches(tfed, data, sl), seq[sl],
                                   key=_key(tfed, 30 + d), owner_parallel=driver == "grouped")
            mets.append(m)
        rows = fed.pager.snapshot(st) if paged else None
        out.append((st, mets, rows, fed.reconcile(st)))
    (sp, mp, rows, lp), (sf, mf, _, lf) = out
    assert lp == lf
    assert torch.equal(sp.theta_L.buf, sf.theta_L.buf)
    for a, b in zip(mp, mf):
        assert all(torch.equal(a[k], b[k]) for k in b)
    bank = sf.bank
    if isinstance(bank, QuantBank):
        np.testing.assert_array_equal(rows["codes"], to_storage(bank.codes)[0])
        np.testing.assert_array_equal(rows["scales"], bank.scales.numpy())
        assert torch.equal(sp.bank.hot.residual, bank.residual)
    else:
        np.testing.assert_array_equal(rows["rows"], to_storage(bank)[0])
    if sf.tree is not None:
        np.testing.assert_array_equal(rows["tree"], sf.tree.nodes.numpy())
        assert torch.equal(sp.tree.counts, sf.tree.counts)


# ---------------------------------- checkpoints --------------------------------------------
@pytest.mark.parametrize("case", ("mixed-f16", "mixed-int8-tree", "staleness"))
def test_checkpoints_cross_the_packages_and_resume(case, tmp_path):
    """Per-example sessions save in either package and restore in the
    other with every leaf bit for bit; the port's restored session then
    runs the remaining rounds as its uninterrupted twin does."""
    params, data, seq = _toy(STATES[case].get("mixed", False))
    half = slice(0, K // 2)
    states = {}
    for mod in (jfed, tfed):
        fed = _fed(mod, case, horizon=K)
        st, _ = fed.run_rounds(fed.init_state(_params(mod, params)), _batches(mod, data, half),
                               seq[half] if mod is tfed else jnp.asarray(seq[half]),
                               key=_key(mod, 6), **_extras(mod, case, half))
        fed.reconcile(st)
        fed.save_session(str(tmp_path / mod.__name__), st)
        states[mod] = (fed, st)
    for src, dst in ((jfed, tfed), (tfed, jfed)):
        fed = _fed(dst, case, horizon=K)
        got = fed.restore_session(str(tmp_path / src.__name__),
                                  fed.init_state(_params(dst, params)))
        flat = flatten_with_paths if dst is tfed else _flatten_with_paths
        want = (flatten_with_paths if src is tfed else _flatten_with_paths)(states[src][1])
        got = flat(got)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    rest = slice(K // 2, K)
    fed_a, sa = states[tfed]
    sa, ma = fed_a.run_rounds(sa, _batches(tfed, data, rest), seq[rest], key=_key(tfed, 7),
                              **_extras(tfed, case, rest))
    fed_b = _fed(tfed, case, horizon=K)
    sb = fed_b.restore_session(str(tmp_path / tfed.__name__),
                               fed_b.init_state(_params(tfed, params)))
    sb, mb = fed_b.run_rounds(sb, _batches(tfed, data, rest), seq[rest], key=_key(tfed, 7),
                              **_extras(tfed, case, rest))
    _assert_bits_equal(_state_bits(sa._replace(ledger=None)), _state_bits(sb._replace(ledger=None)))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert fed_a.reconcile(sa) == fed_b.reconcile(sb)


# ------------------------------ carried across from numpy ----------------------------------
@pytest.mark.parametrize("case", ("mixed-f16", "mixed-int8-tree"))
def test_a_reference_flat_state_carries_across_and_runs_on(case):
    """The reference's mid-run flat state with bf16 and f16 leaves (an f16
    bank, or an int8 bank with the tree) carried across through numpy
    (`flat_state_from_numpy`): the same spec and bits, and the next rounds
    agree with the reference's within the tolerances."""
    params, data, seq = _toy(True)
    half, rest = slice(0, K // 2), slice(K // 2, K)
    jf = _fed(jfed, case, horizon=K)
    js, _ = jf.run_rounds(jf.init_state(_params(jfed, params)), _batches(jfed, data, half),
                          jnp.asarray(seq[half]), key=_key(jfed, 6))
    spec = flat_spec_from_numpy(params)
    jspec = js.theta_L.spec
    assert (spec.shapes, spec.offsets, spec.size) == (jspec.shapes, jspec.offsets, jspec.size)
    assert [str(d).replace("torch.", "") for d in spec.dtypes] == [d.name for d in jspec.dtypes]
    bank = js.bank
    if STATES[case].get("bank") == "int8":
        bank = quant_bank_from_numpy(np.asarray(bank.codes), np.asarray(bank.scales),
                                     np.asarray(bank.residual), "int8", device=CPU)
    else:
        bank = np.asarray(bank)
    tree = None if js.tree is None else tree_noise_from_numpy(
        np.asarray(js.tree.nodes), np.asarray(js.tree.counts), js.tree.depth, device=CPU)
    led = js.ledger
    ts = flat_state_from_numpy(params, np.asarray(js.theta_L.buf), bank, int(js.step), tree=tree,
                               ledger=device_ledger_from_numpy(
                                   *(np.asarray(getattr(led, c)) for c in ("spent", "cap",
                                                                           "refused")),
                                   device=CPU), device=CPU)
    assert ts.theta_L.spec.dtypes == spec.dtypes
    np.testing.assert_array_equal(_bits(ts.theta_L.buf), _bits(js.theta_L.buf))
    tf = _fed(tfed, case, horizon=K)
    # this session's accountant starts where the reference's device ledger is
    for i, n in enumerate(np.asarray(led.spent)):
        tf.mechanism.authorize_many(i, int(n))
    ts = ts._replace(ledger=tf.mechanism.device_ledger(CPU))
    ts, tm = tf.run_rounds(ts, _batches(tfed, data, rest), seq[rest], key=_key(tfed, 8))
    js, jm = jf.run_rounds(js, _batches(jfed, data, rest), jnp.asarray(seq[rest]),
                           key=_key(jfed, 8))
    np.testing.assert_array_equal(_f32(tm["refused"]), _f32(jm["refused"]))
    _close(ts.theta_L.buf, js.theta_L.buf)
    _bank_close(ts.bank, js.bank, case)
    for k, leaf in tf.params_of(ts).items():
        assert leaf.dtype == params_from_numpy(params, device=CPU)[k].dtype
    with pytest.raises(ValueError, match="packed buffer"):
        flat_state_from_numpy(params, np.zeros(3, np.float32), bank, device=CPU)
    with pytest.raises(TypeError, match="packable"):
        flat_spec_from_numpy({"w": np.zeros(3, np.float64)})
