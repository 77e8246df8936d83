"""The port's paged owner bank (`flatten.PagedBank`, `federation.paging`,
`schedules.TraceRing`) on the CPU, and held against the JAX reference's.

Inside the port, as tests/test_paged_bank.py holds the reference: the
cold-tier row stores round-trip f32, bf16, int8 and fp8 rows bit for bit
(memory and memmap; the memmap is created at the first write and stays
sparse); the page table resolves owners with the sentinel padding; with
every dispatched row resident the PAGED engine equals the FLAT one bit
for bit on the step loop, `make_fused_rounds` and `make_group_rounds`,
over f32, int8 and fp8 banks (bf16 on the sequential drivers; the grouped
driver refuses bf16, paged or not), under refusals, under a FaultPlan and
under the tree; rows evicted to the cold tier (in memory and on disk)
come back bit for bit; a TraceRing run equals the materialized trace; a
round whose owner is not resident is refused, spends nothing and leaves
the state as it was (on all three drivers); an oversized window raises;
a paged save_session round-trips.

Against the reference, under one schedule: the pager's resident ids,
stats, dirty set and eviction order (the rows written back, in order),
the ledger, the tiled fault checksums and the TraceRing's windows equal
the reference's exactly; theta_L and the bank agree within the tolerances
of tests/test_torch_federation.py (rtol 1e-4, atol 1e-6; int8 codes
within one step).

The reference's 1x1-mesh test of the paged engine waits for the port's
sharding (ROADMAP queue 1, item 7).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federation as jfed
import repro_torch.federation as tfed
from repro.checkpoint import MemoryRowStore as JMemoryRowStore
from repro_torch import random as trandom
from repro_torch.checkpoint import MemmapRowStore, MemoryRowStore
from repro_torch.convert import params_from_numpy
from repro_torch.federation import PagedBank, QuantBank
from repro_torch.federation.deep import AsyncDPConfig, make_fused_rounds, make_group_rounds
from repro_torch.federation.deep import make_train_step
from repro_torch.federation.faults import row_checksum
from repro_torch.federation.paging import init_paged_state
from repro_torch.federation.schedules import TraceRing

CPU = "cpu"
N, K = 8, 24
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal(6).astype(np.float32), "b": np.zeros((), np.float32)}
    data = {"x": rng.standard_normal((K, 4, 6)).astype(np.float32),
            "y": rng.standard_normal((K, 4)).astype(np.float32)}
    return params, data


def _loss(mod):
    if mod is jfed:
        return lambda p, b: jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
    return lambda p, b: torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _priv(mod, fused=True):
    return mod.PrivatizerConfig(xi=1.0, granularity="microbatch", n_microbatches=2,
                                fused_kernel=fused)


def _fed(mod=tfed, bank_dtype=None, horizon=3, fused=True, **kw):
    if mod is tfed:
        kw["device"] = CPU
    fed = mod.Federation([mod.DataOwner(n=100, epsilon=1.0, xi=1.0) for _ in range(N)],
                         mod.FederationConfig(horizon=horizon, sigma=1e-2, theta_max=10.0,
                                              lr_scale=5.0), **kw)
    fed.make_step(_loss(mod), privatizer=_priv(mod, fused), pack_params=True,
                  bank_dtype=bank_dtype)
    return fed


def _params(mod, params):
    if mod is jfed:
        return {k: jnp.asarray(v) for k, v in params.items()}
    return params_from_numpy(params, device=CPU)


def _batches(mod, data, sl=slice(None)):
    if mod is jfed:
        return {k: jnp.asarray(v[sl]) for k, v in data.items()}
    return {k: torch.from_numpy(v[sl].copy()) for k, v in data.items()}


def _key(seed):
    return trandom.PRNGKey(seed, device=CPU)


def _seq(seed):
    return np.random.default_rng(seed).integers(0, N, K)


def _bank_tensors(bank):
    bank = bank.hot if isinstance(bank, PagedBank) else bank
    if isinstance(bank, QuantBank):
        return {"codes": bank.codes, "scales": bank.scales, "residual": bank.residual}
    return {"rows": bank}


def _assert_states_equal(sf, sp, mf=None, mp=None):
    """Flat against paged with n_hot = N: everything bit for bit."""
    assert torch.equal(sf.theta_L.buf, sp.theta_L.buf)
    fb, pb = _bank_tensors(sf.bank), _bank_tensors(sp.bank)
    assert fb.keys() == pb.keys()
    for k in fb:
        assert torch.equal(fb[k], pb[k]), k
    for c in sf.ledger.COLUMNS:
        assert torch.equal(getattr(sf.ledger, c), getattr(sp.ledger, c)), c
    assert int(sf.step) == int(sp.step)
    if sf.faults is not None:
        for a, b in zip(sf.faults, sp.faults):
            assert torch.equal(a, b)
    if sf.tree is not None:
        assert torch.equal(sf.tree.nodes, sp.tree.nodes)
        assert torch.equal(sf.tree.counts, sp.tree.counts)
    if mf is not None:
        assert mf.keys() == mp.keys()
        for k in mf:
            assert torch.equal(mf[k], mp[k]), k


def _snapshot_equals_flat(fed_p, sp, sf):
    snap = fed_p.pager.snapshot(sp)
    fb = _bank_tensors(sf.bank)
    for k in fb.keys() & snap.keys():
        want = fb[k].view(torch.uint16) if fb[k].dtype == torch.bfloat16 else fb[k]
        np.testing.assert_array_equal(want.numpy(), snap[k], err_msg=k)
    if sf.tree is not None:
        np.testing.assert_array_equal(sf.tree.nodes.numpy(), snap["tree"])


# ---------------------------------- cold-tier row stores ------------------------------------
DTYPES = {"float32": (np.float32, None), "bfloat16": (np.uint16, torch.bfloat16),
          "int8": (np.int8, None), "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["memory", "memmap"])
def test_row_store_bit_exact_roundtrip(tmp_path, kind, dtype):
    storage, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)

    def rows(*shape):
        raw = rng.integers(-100, 100, shape) if storage == np.int8 else rng.integers(
            0, 255 if storage == np.uint8 else 60000, shape)
        return raw.astype(storage)

    default = rows(5)
    if kind == "memory":
        store = MemoryRowStore(10, (5,), dtype, default)
    else:
        store = MemmapRowStore(str(tmp_path / dtype), 10, (5,), dtype, default)
    assert store.dtype == dtype
    np.testing.assert_array_equal(store.read_rows(np.array([0, 7])), np.stack([default] * 2))
    vals = rows(3, 5)
    # rows may come in as tensors of the logical dtype
    given = torch.from_numpy(vals).view(tdt) if tdt is not None else vals
    store.write_rows(np.array([2, 7, 9]), given)
    back = store.read_rows(np.array([2, 7, 9, 0]))
    assert back.dtype == storage
    np.testing.assert_array_equal(back[:3], vals)
    np.testing.assert_array_equal(back[3], default)
    assert store.written == 3
    np.testing.assert_array_equal(store.written_ids, [2, 7, 9])
    store.clear()
    assert store.written == 0
    np.testing.assert_array_equal(store.read_rows([7])[0], default)


def test_row_store_bounds_checked():
    store = MemoryRowStore(4, (2,), np.float32, np.zeros(2, np.float32))
    with pytest.raises(IndexError):
        store.read_rows(np.array([4]))
    with pytest.raises(IndexError):
        store.write_rows(np.array([-1]), np.zeros((1, 2), np.float32))
    with pytest.raises(ValueError, match="shape"):
        store.write_rows(np.array([1]), np.zeros((1, 3), np.float32))


def test_memmap_store_is_lazy(tmp_path):
    path = tmp_path / "big"
    store = MemmapRowStore(str(path), 1_000_000, (64,), np.float32, np.zeros(64, np.float32))
    assert not os.path.exists(path / "rows.npy")          # nothing until the first write
    np.testing.assert_array_equal(store.read_rows([5]), np.zeros((1, 64), np.float32))
    store.write_rows(np.array([123_456]), np.ones((1, 64), np.float32))
    store.flush()
    blocks = os.stat(path / "rows.npy").st_blocks * 512
    assert blocks < 8 * 64 * 4 * 1_000_000 / 100
    np.testing.assert_array_equal(store.read_rows([123_456]), np.ones((1, 64), np.float32))


def test_row_store_reads_as_the_reference_store():
    rng = np.random.default_rng(4)
    default = rng.standard_normal(7).astype(np.float32)
    ours, theirs = MemoryRowStore(6, (7,), np.float32, default), JMemoryRowStore(
        6, (7,), np.float32, default)
    vals = rng.standard_normal((3, 7)).astype(np.float32)
    for s in (ours, theirs):
        s.write_rows([4, 1, 5], vals)
    ids = np.array([0, 1, 2, 3, 4, 5])
    np.testing.assert_array_equal(ours.read_rows(ids), theirs.read_rows(ids))
    np.testing.assert_array_equal(ours.written_ids, theirs.written_ids)
    assert str(ours.dtype) == str(theirs.dtype)


# -------------------------------------- the page table ---------------------------------------
def test_paged_bank_lookup():
    bank = PagedBank(torch.zeros((4, 3)), torch.tensor([2, 5, 9, 12], dtype=torch.int32), 20)
    for owner, want_slot, want_hit in [(2, 0, True), (5, 1, True), (9, 2, True), (12, 3, True),
                                       (0, 0, False), (7, 2, False), (19, 3, False)]:
        slot, hit = bank.lookup(torch.tensor([owner]))
        assert bool(hit) is want_hit, owner
        if want_hit:
            assert int(slot) == want_slot
        assert 0 <= int(slot) < 4
    # a (g,) int64 owner vector (the grouped driver's), the table untouched
    slot, hit = bank.lookup(torch.tensor([12, 7, 2], dtype=torch.int64))
    assert slot.dtype == torch.int64 and slot.tolist() == [3, 2, 0]
    assert hit.tolist() == [True, False, True]
    assert bank.hot_ids.dtype == torch.int32
    # as jnp.searchsorted (left side) on the same table
    jb = jfed.PagedBank(jnp.zeros((4, 3)), jnp.asarray([2, 5, 9, 12], jnp.int32), 20)
    for o in range(20):
        js, jh = jb.lookup(jnp.int32(o))
        ts, th = bank.lookup(torch.tensor(o))
        assert (int(js), bool(jh)) == (int(ts), bool(th))


def test_lookup_with_sentinel_padding():
    bank = PagedBank(torch.zeros((5, 2)), torch.tensor([3, 6, 10, 10, 10], dtype=torch.int32), 10)
    assert bool(bank.lookup(torch.tensor(3))[1])
    assert bool(bank.lookup(torch.tensor(6))[1])
    assert not bool(bank.lookup(torch.tensor(9))[1])
    assert bank.n_hot == 5 and bank.size == 2 and bank.codec is None
    assert bank.nbytes == 5 * 2 * 4 + 5 * 4


# ----------------------------- full residency: paged == flat ----------------------------------
@pytest.mark.parametrize("bank_dtype", [None, torch.bfloat16, "int8", "fp8"])
def test_fused_paged_matches_flat_bit_exact(toy, bank_dtype):
    # horizon 3 over 24 rounds: refusals interleave, so the paged grant
    # masking is exercised, not only the happy path
    params, data = toy
    seq = _seq(3)
    fed_f = _fed(bank_dtype=bank_dtype)
    sf, mf = fed_f.run_rounds(fed_f.init_state(_params(tfed, params)), _batches(tfed, data),
                              seq, key=_key(4))
    fed_p = _fed(bank_dtype=bank_dtype)
    sp, mp = fed_p.run_rounds(fed_p.init_paged_state(_params(tfed, params), n_hot=N),
                              _batches(tfed, data), seq, key=_key(4))
    assert int(mf["refused"].sum()) > 0
    _assert_states_equal(sf, sp, mf, mp)


@pytest.mark.parametrize("bank_dtype", [None, torch.bfloat16, "int8"])
def test_step_loop_paged_matches_flat(toy, bank_dtype):
    params, data = toy
    seq = _seq(5)
    keys = trandom.split(_key(6), K)
    fed_f = _fed(bank_dtype=bank_dtype)
    sf = fed_f.init_state(_params(tfed, params))
    fed_p = _fed(bank_dtype=bank_dtype)
    sp = fed_p.init_paged_state(_params(tfed, params), n_hot=3)     # paging traffic
    for k in range(K):
        b = {n: v[k] for n, v in _batches(tfed, data).items()}
        sf, mf = fed_f.step(sf, b, int(seq[k]), keys[k])
        sp, mp = fed_p.step(sp, b, int(seq[k]), keys[k])
        assert mf["refused"] == mp["refused"], k
    assert torch.equal(sf.theta_L.buf, sp.theta_L.buf)
    assert int(sf.step) == int(sp.step)
    _snapshot_equals_flat(fed_p, sp, sf)
    assert fed_f.ledger() == fed_p.ledger()
    assert fed_p.pager.stats["evictions"] > 0


@pytest.mark.parametrize("bank_dtype", [None, "int8", "fp8"])
def test_grouped_paged_matches_flat(toy, bank_dtype):
    params, data = toy
    seq = _seq(7)
    kw = dict(owner_parallel=True, max_group=4)
    fed_f = _fed(bank_dtype=bank_dtype)
    sf, mf = fed_f.run_rounds(fed_f.init_state(_params(tfed, params)), _batches(tfed, data),
                              seq, key=_key(8), **kw)
    fed_p = _fed(bank_dtype=bank_dtype)
    sp, mp = fed_p.run_rounds(fed_p.init_paged_state(_params(tfed, params), n_hot=N),
                              _batches(tfed, data), seq, key=_key(8), **kw)
    _assert_states_equal(sf, sp, mf, mp)


def test_grouped_driver_refuses_a_paged_bf16_bank(toy):
    params, data = toy
    fed = _fed(bank_dtype=torch.bfloat16)
    sp = fed.init_paged_state(_params(tfed, params), n_hot=N)
    with pytest.raises(NotImplementedError, match="grouped driver"):
        fed.run_rounds(sp, _batches(tfed, data), np.arange(K) % N, key=_key(8),
                       owner_parallel=True, max_group=4)


@pytest.mark.parametrize("driver", ["sequential", "grouped", "step"])
@pytest.mark.parametrize("bank_dtype", [None, "int8"])
def test_faulted_paged_matches_flat(toy, driver, bank_dtype):
    params, data = toy
    plan_kw = dict(drop=0.2, stale=0.1, nonfinite=0.2, corrupt=0.2)
    seq = _seq(9)
    fkw = dict(fault_policy=tfed.FaultPolicy(max_faults=2, window=8),
               staleness=tfed.StalenessPolicy(deadline=1.0, max_retries=2, decay=0.9))
    fed_f, fed_p = _fed(bank_dtype=bank_dtype, **fkw), _fed(bank_dtype=bank_dtype, **fkw)
    sf = fed_f.init_state(_params(tfed, params))
    sp = fed_p.init_paged_state(_params(tfed, params), n_hot=N)
    if driver == "step":
        codes = tfed.FaultPlan(**plan_kw).draw(_key(10), K)
        keys = trandom.split(_key(11), K)
        for k in range(K):
            b = {n: v[k] for n, v in _batches(tfed, data).items()}
            sf, mf = fed_f.step(sf, b, int(seq[k]), keys[k], fault_code=int(codes[k]))
            sp, mp = fed_p.step(sp, b, int(seq[k]), keys[k], fault_code=int(codes[k]))
            assert mf == mp or all(bool(torch.as_tensor(mf[n] == mp[n]).all()) for n in mf)
        _assert_states_equal(sf, sp)
        return
    kw = dict(owner_parallel=True, max_group=4) if driver == "grouped" else {}
    lat = tfed.LatencyPlan(base=0.6, jitter=0.6)
    sf, mf = fed_f.run_rounds(sf, _batches(tfed, data), seq, key=_key(10),
                              faults=tfed.FaultPlan(**plan_kw), latency=lat, **kw)
    sp, mp = fed_p.run_rounds(sp, _batches(tfed, data), seq, key=_key(10),
                              faults=tfed.FaultPlan(**plan_kw), latency=lat, **kw)
    assert int(mf["faulted"].sum()) > 0
    _assert_states_equal(sf, sp, mf, mp)
    for a, b in zip(sf.stale, sp.stale):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["sequential", "grouped", "reference-mode", "faults"])
def test_tree_paged_matches_flat(toy, form):
    params, data = toy
    seq = _seq(12)
    kw = dict(mechanism="tree", tree_depth=3, horizon=7)
    if form == "faults":
        kw["fault_policy"] = tfed.FaultPolicy(max_faults=3, window=8)
    fused = form != "reference-mode"
    run_kw = dict(owner_parallel=True, max_group=4) if form == "grouped" else {}
    if form == "faults":
        run_kw["faults"] = tfed.FaultPlan(drop=0.2, nonfinite=0.2, corrupt=0.2)
    fed_f, fed_p = _fed(fused=fused, **kw), _fed(fused=fused, **kw)
    sf, mf = fed_f.run_rounds(fed_f.init_state(_params(tfed, params)), _batches(tfed, data),
                              seq, key=_key(13), **run_kw)
    sp, mp = fed_p.run_rounds(fed_p.init_paged_state(_params(tfed, params), n_hot=N),
                              _batches(tfed, data), seq, key=_key(13), **run_kw)
    assert tuple(sp.tree.nodes.shape) == (N, 3, 7)
    _assert_states_equal(sf, sp, mf, mp)


# ------------------------------- eviction and streaming ---------------------------------------
@pytest.mark.parametrize("case", ["f32-memmap", "int8-memory", "bf16-memmap", "tree-memory"])
def test_eviction_roundtrip_bit_exact(toy, tmp_path, case):
    # n_hot 3 over 8 owners loads and evicts rows every dispatch; the flat
    # run takes the same chunked dispatches, so a row corrupted through the
    # cold tier breaks the parity
    params, data = toy
    bank_dtype = {"int8": "int8", "bf16": torch.bfloat16}.get(case.split("-")[0])
    kw = dict(mechanism="tree", tree_depth=3, horizon=7) if case.startswith("tree") else {}
    cold = str(tmp_path) if case.endswith("memmap") else None
    seq = _seq(11)
    keys = trandom.split(_key(12), K // 3)
    fed_f, fed_p = _fed(bank_dtype=bank_dtype, **kw), _fed(bank_dtype=bank_dtype, **kw)
    sf = fed_f.init_state(_params(tfed, params))
    sp = fed_p.init_paged_state(_params(tfed, params), n_hot=3, cold_dir=cold)
    for c in range(K // 3):
        sl = slice(3 * c, 3 * c + 3)
        sf, _ = fed_f.run_rounds(sf, _batches(tfed, data, sl), seq[sl], key=keys[c])
        sp, _ = fed_p.run_rounds(sp, _batches(tfed, data, sl), seq[sl], key=keys[c])
    assert fed_p.pager.stats["evictions"] > 0 and fed_p.pager.stats["writebacks"] > 0
    assert torch.equal(sf.theta_L.buf, sp.theta_L.buf)
    _snapshot_equals_flat(fed_p, sp, sf)
    for c in sf.ledger.COLUMNS:
        assert torch.equal(getattr(sf.ledger, c), getattr(sp.ledger, c))
    if cold is not None:
        assert os.path.exists(os.path.join(cold, "rows", "rows.npy"))


def test_trace_ring_run_matches_materialized_trace(toy):
    params, data = toy
    trace = (0, 5, 2, 7, 1, 3)
    windows = tuple((0.0, 1.0) for _ in range(N))
    tiled = np.resize(trace, K)
    # one dispatch through a ring whose chunk holds it
    fed_a = _fed()
    sa, ma = fed_a.run_rounds(fed_a.init_state(_params(tfed, params)), _batches(tfed, data),
                              tiled, key=_key(13))
    fed_b = _fed()
    ring = tfed.AvailabilityTraceSchedule(windows, trace=trace).trace_ring(chunk=32, device=CPU)
    sb, mb = fed_b.run_rounds(fed_b.init_paged_state(_params(tfed, params), n_hot=6),
                              _batches(tfed, data), ring, key=_key(13))
    assert torch.equal(sa.theta_L.buf, sb.theta_L.buf)
    assert torch.equal(ma["refused"], mb["refused"]) and torch.equal(ma["owner"], mb["owner"])
    _snapshot_equals_flat(fed_b, sb, sa)
    assert ring.resident_bytes == 32 * 4 and ring.cursor == K
    # four dispatches of 6 through a chunk of 4 (refills mid-trace) and of
    # 5 < 6 (direct uploads), against the same dispatches of the tiled trace
    for chunk in (4, 5):
        fed_c, fed_d = _fed(), _fed()
        sc = fed_c.init_state(_params(tfed, params))
        sd = fed_d.init_paged_state(_params(tfed, params), n_hot=6)
        ring = TraceRing(trace, chunk=chunk, device=CPU)
        for c in range(4):
            sl = slice(6 * c, 6 * c + 6)
            window = ring.window(6)
            np.testing.assert_array_equal(window, tiled[sl])
            sc, mc = fed_c.run_rounds(sc, _batches(tfed, data, sl), tiled[sl], key=_key(20 + c))
            sd, md = fed_d.run_rounds(sd, _batches(tfed, data, sl), ring, key=_key(20 + c))
            assert torch.equal(mc["owner"], md["owner"])
        assert torch.equal(sc.theta_L.buf, sd.theta_L.buf)
        _snapshot_equals_flat(fed_d, sd, sc)


def test_trace_ring_equals_reference_ring():
    trace = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5], np.int32)
    ours, theirs = TraceRing(trace, chunk=4, device=CPU), jfed.TraceRing(trace, chunk=4)
    for k in (3, 1, 4, 6, 2, 9, 1):
        np.testing.assert_array_equal(ours.window(k), theirs.window(k))
        got, want = ours.next(k), theirs.next(k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert ours.cursor == theirs.cursor and ours.resident_bytes == theirs.resident_bytes
    np.testing.assert_array_equal(ours.window(20), np.resize(np.roll(trace, -(ours.cursor % 9)),
                                                             20))
    for bad in (dict(trace=[]), dict(trace=[1], chunk=0)):
        with pytest.raises(ValueError):
            TraceRing(**bad, device=CPU)
    with pytest.raises(ValueError, match="recorded trace"):
        tfed.AvailabilityTraceSchedule(((0.0, 1.0),)).trace_ring(device=CPU)


# ------------------------------------ miss semantics ------------------------------------------
def _miss_setup(params):
    cfg = AsyncDPConfig(n_owners=N, horizon=16, epsilons=(1.0,) * N, owner_sizes=(100,) * N,
                        caps=(5,) * N, privatizer=_priv(tfed))
    state, _ = init_paged_state(_params(tfed, params), cfg, n_hot=3, device=CPU)  # {0,1,2}
    return cfg, state


def test_page_miss_is_refused_and_spends_nothing(toy):
    # the fused driver alone, with no pager: owners past the initial
    # residency miss the page table
    params, data = toy
    cfg, state = _miss_setup(params)
    hot0, ids0 = state.bank.hot.clone(), state.bank.hot_ids.clone()
    run = make_fused_rounds(_loss(tfed), cfg, device=CPU)
    seq = np.array([0, 6, 1, 7, 2, 5])
    out, m = run(state, _batches(tfed, data, slice(0, 6)), torch.from_numpy(seq),
                 trandom.split(_key(14), 6))
    assert m["refused"].tolist() == [False, True, False, True, False, True]
    assert out.ledger.spent.tolist() == [1, 1, 1, 0, 0, 0, 0, 0]
    assert out.ledger.refused.tolist() == [0, 0, 0, 0, 0, 1, 1, 1]
    assert torch.equal(out.bank.hot_ids, ids0)
    assert int(out.step) == 3
    # only the missed rounds: the state is as it was
    cfg, state = _miss_setup(params)
    theta0 = state.theta_L.buf.clone()
    out, m = run(state, _batches(tfed, data, slice(0, 3)), torch.tensor([6, 7, 5]),
                 trandom.split(_key(15), 3))
    assert bool(m["refused"].all()) and int(out.step) == 0
    assert torch.equal(out.theta_L.buf, theta0) and torch.equal(out.bank.hot, hot0)
    assert out.ledger.spent.tolist() == [0] * N


def test_page_miss_on_the_grouped_driver_and_the_step(toy):
    params, data = toy
    cfg, state = _miss_setup(params)
    group = make_group_rounds(_loss(tfed), cfg, device=CPU)
    # one group: resident 0 and 2, and 6 and 7 (which clamp to slot 2)
    seq = torch.tensor([6, 2, 7, 0])
    flat_cfg, fstate = _miss_setup(params)
    out, m = group(state, _batches(tfed, data, slice(0, 4)), seq, trandom.split(_key(16), 4),
                   np.array([[0, 1, 2, 3]]), np.ones((1, 4), bool))
    assert m["refused"].tolist() == [True, False, True, False]
    assert out.ledger.spent.tolist() == [1, 0, 1, 0, 0, 0, 0, 0]
    assert out.ledger.refused.tolist() == [0, 0, 0, 0, 0, 0, 1, 1]
    # the resident members equal a group of the two alone
    ref, _ = group(fstate, _batches(tfed, data, slice(0, 4)), seq, trandom.split(_key(16), 4),
                   np.array([[0, 1, 2, 3]]), np.ones((1, 4), bool))
    assert torch.equal(out.bank.hot, ref.bank.hot)
    step = make_train_step(_loss(tfed), cfg, device=CPU)
    _, state = _miss_setup(params)
    hot0, theta0 = state.bank.hot.clone(), state.theta_L.buf.clone()
    out, _ = step(state, {k: v[0] for k, v in _batches(tfed, data).items()},
                  torch.tensor(6), _key(17))
    assert int(out.step) == 0
    assert torch.equal(out.bank.hot, hot0) and torch.equal(out.theta_L.buf, theta0)


def test_prefetch_rejects_oversized_window(toy):
    params, _ = toy
    fed = _fed()
    state = fed.init_paged_state(_params(tfed, params), n_hot=3)
    with pytest.raises(ValueError, match="n_hot"):
        fed.pager.prefetch(state, np.arange(5))
    with pytest.raises(ValueError, match="out of range"):
        fed.pager.prefetch(state, np.array([N]))
    with pytest.raises(ValueError, match="n_hot"):
        fed.init_paged_state(_params(tfed, params), n_hot=0)
    flat = tfed.Federation([tfed.DataOwner(n=100, epsilon=1.0, xi=1.0)] * N,
                           tfed.FederationConfig(horizon=3), device=CPU)
    flat.make_step(_loss(tfed), privatizer=_priv(tfed))
    with pytest.raises(ValueError, match="pack_params"):
        flat.init_paged_state(_params(tfed, params), n_hot=3)


def test_save_session_round_trips_paged_states(toy, tmp_path):
    params, data = toy
    fed_a = _fed(horizon=K)
    sa = fed_a.init_paged_state(_params(tfed, params), n_hot=N)
    sa, _ = fed_a.run_rounds(sa, _batches(tfed, data), _seq(21), key=_key(22))
    led = fed_a.reconcile(sa)
    fed_a.save_session(str(tmp_path), sa)
    fed_b = _fed(horizon=K)
    sb = fed_b.restore_session(str(tmp_path),
                               fed_b.init_paged_state(_params(tfed, params), n_hot=N))
    assert torch.equal(sb.theta_L.buf, sa.theta_L.buf)
    assert torch.equal(sb.bank.hot, sa.bank.hot)
    assert torch.equal(sb.bank.hot_ids, sa.bank.hot_ids)
    assert fed_b.reconcile(sb) == led


# --------------------------------- against the reference -------------------------------------
def _record_writebacks(pager):
    """Wrap every cold store's write_rows to log the owner ids written, in
    order (the eviction and flush order)."""
    log = []
    store = next(iter(pager.stores.values()))
    orig = store.write_rows

    def write_rows(ids, values):
        log.append([int(i) for i in np.asarray(ids).reshape(-1)])
        return orig(ids, values)

    store.write_rows = write_rows
    return log


@pytest.mark.parametrize("bank_dtype", [None, "int8"])
def test_pager_bookkeeping_equals_reference(toy, bank_dtype):
    params, data = toy
    seq = _seq(30)
    chunks = [slice(3 * c, 3 * c + 3) for c in range(K // 3)]
    feds, states, logs = {}, {}, {}
    for mod in (jfed, tfed):
        fed = _fed(mod, bank_dtype=bank_dtype, horizon=6,
                   fault_policy=mod.FaultPolicy(max_faults=3, window=8))
        st = fed.init_paged_state(_params(mod, params), n_hot=3)
        logs[mod] = _record_writebacks(fed.pager)
        trail = []
        for c, sl in enumerate(chunks):
            key = jax.random.PRNGKey(40 + c) if mod is jfed else _key(40 + c)
            s = seq[sl] if mod is tfed else jnp.asarray(seq[sl])
            st, _ = fed.run_rounds(st, _batches(mod, data, sl), s, key=key,
                                   faults=mod.FaultPlan(drop=0.2, corrupt=0.1))
            trail.append((fed.pager.resident_ids.tolist(), sorted(fed.pager.dirty),
                          dict(fed.pager.stats)))
        feds[mod], states[mod] = fed, (st, trail)
    (js, jtrail), (ts, ttrail) = states[jfed], states[tfed]
    assert ttrail == jtrail
    assert logs[tfed] == logs[jfed]
    np.testing.assert_array_equal(ts.bank.hot_ids.numpy(), np.asarray(js.bank.hot_ids))
    for c in ts.ledger.COLUMNS:
        np.testing.assert_array_equal(getattr(ts.ledger, c).numpy(),
                                      np.asarray(getattr(js.ledger, c)))
    for name in ("win_faults", "contacts", "quarantined"):
        np.testing.assert_array_equal(getattr(ts.faults, name).numpy(),
                                      np.asarray(getattr(js.faults, name)))
    np.testing.assert_allclose(ts.theta_L.buf.numpy(), np.asarray(js.theta_L.buf),
                               rtol=RTOL, atol=ATOL)
    tsnap, jsnap = feds[tfed].pager.snapshot(ts), feds[jfed].pager.snapshot(js)
    if bank_dtype is None:
        np.testing.assert_allclose(tsnap["rows"], jsnap["rows"], rtol=RTOL, atol=ATOL)
    else:
        dcode = np.abs(tsnap["codes"].astype(np.int32) - jsnap["codes"].astype(np.int32))
        assert dcode.max() <= 1
        np.testing.assert_allclose(tsnap["scales"], jsnap["scales"], rtol=1e-5, atol=0)
    assert feds[tfed].reconcile(ts) == feds[jfed].reconcile(js)


@pytest.mark.parametrize("bank_dtype", [None, "int8", "fp8"])
def test_tiled_fault_checksums_equal_reference(toy, bank_dtype):
    params, _ = toy
    got, want = [], []
    for mod, out in ((jfed, want), (tfed, got)):
        fed = _fed(mod, bank_dtype=bank_dtype, fault_policy=mod.FaultPolicy())
        st = fed.init_paged_state(_params(mod, params), n_hot=3)
        out.append(np.asarray(st.faults.checksum))
        if mod is tfed:
            # one row's sum, tiled: the default row's checksum for all N
            one = row_checksum(st.bank, torch.zeros(1, dtype=torch.int64))
            assert st.faults.checksum.tolist() == [int(one)] * N
    np.testing.assert_array_equal(got[0], want[0])
