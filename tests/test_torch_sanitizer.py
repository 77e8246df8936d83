"""The port's runtime key-reuse sanitizer over its real engines (tier 1,
on the CPU at toy size), the counterpart of tests/test_sanitizer.py.

`repro_torch.analysis.dpcheck.sanitize()` patches the ``repro_torch.random``
samplers and ``split`` and hears the kernel entry points' in-kernel draws
(``random.report_draw``, on their CUDA branch; on the CPU their plain
versions' own sampler call records the draw). These tests drive the
sequential, grouped and sync deep drivers, the convex engine, the tree
mechanism, the int8 and fp8 banks and fault-armed dispatches and assert (a)
no key's counters are drawn twice and (b) coverage is total: `skipped` is
0. Then the instrument itself: reuse, draw-after-split and double split
raise, `fold_in` is lawful, `repro_torch.random` is restored on exit,
disjoint counter ranges of one key are lawful and overlapping ones raise,
a batch of keys is checked row by row, a replay must redraw what was
drawn, and unreadable (meta) keys are counted as skipped. Each kernel
entry point records one draw per key here; its counterpart on the card
(the launch's own report) is in tests/test_torch_cuda.py, which imports
no jax.

Against the reference's sanitizer over the reference's run at the same
config: on the sequential driver both record the same draws and splits.
The grouped driver differs by design: the reference's vmap hands its
sampler one (g, 2) batch of keys, which it hashes as one unit, while the
port records each member's key (one row of the batch), so the port counts
g draws (and, unfused, g splits) where the reference counts one per group
(and one group more: see test_recorders_agree_with_reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federation as jfed
from repro.analysis.dpcheck import sanitize as jsanitize
from repro_torch import random
from repro_torch.analysis.dpcheck import KeyReuseError, sanitize
from repro_torch.analysis.dpcheck._sanitize import block_intervals
from repro_torch.federation import (DataOwner, FaultPlan, FaultPolicy, Federation,
                                    FederationConfig, LatencyPlan, PrivatizerConfig,
                                    StalenessPolicy, federate_problem,
                                    partition_conflict_free)
from repro_torch.kernels.bank_codec import ops as bops
from repro_torch.kernels.dp_clip_noise import ops as dops
from repro_torch.kernels.tree_noise import ops as nops

CPU = "cpu"
N_OWNERS, K = 4, 6
SEQ = [0, 1, 2, 3, 0, 1]


@pytest.fixture(autouse=True)
def _one_thread():
    # one torch thread per test process: the suite runs in several workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    key = jax.random.PRNGKey(0)
    jparams = {"w": jax.random.normal(key, (6, 3)), "b": jnp.zeros((3,))}
    jbatches = {"x": jax.random.normal(jax.random.PRNGKey(1), (K, 4, 6)),
                "y": jax.random.normal(jax.random.PRNGKey(2), (K, 4, 3))}
    params = {k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}
    batches = {k: torch.tensor(np.asarray(v)) for k, v in jbatches.items()}
    return jparams, jbatches, params, batches


def _jax_loss(p, b):
    return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _loss(p, b):
    return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _fed(fused=True, pack=True, bank=None, **fed_kw):
    owners = [DataOwner(n=100, epsilon=1.0, xi=1.0) for _ in range(N_OWNERS)]
    fed = Federation(owners, FederationConfig(horizon=8, sigma=1e-2, theta_max=10.0,
                                              lr_scale=5.0), device=CPU, **fed_kw)
    fed.make_step(_loss, privatizer=PrivatizerConfig(xi=1.0, granularity="example",
                                                     fused_kernel=fused),
                  pack_params=pack, **({"bank_dtype": bank} if bank else {}))
    return fed


def _run(fed, params, batches, **kw):
    state = fed.init_state(params)
    with sanitize() as rec:
        state, ms = fed.run_rounds(state, batches, torch.tensor(SEQ, dtype=torch.int32),
                                   key=random.PRNGKey(7, device=CPU), **kw)
    assert rec.skipped == 0 and rec.draws > 0
    return rec, state, ms


ARMED = dict(fault_policy=FaultPolicy(), staleness=StalenessPolicy())
PLANS = dict(faults=FaultPlan(drop=0.2, corrupt=0.2), latency=LatencyPlan(base=0.5, jitter=1.0))
CASES = {
    # name: (_fed kwargs, run_rounds kwargs, draws, splits)
    "f32": ({}, {}, K, 1),
    "f32-unfused": (dict(fused=False), {}, 2 * K, 1 + K),
    "int8": (dict(bank="int8"), {}, 2 * K, 1),
    "fp8": (dict(bank="fp8"), {}, 2 * K, 1),
    "pytree": (dict(pack=False), {}, 2 * K, 1 + K),
    "tree": (dict(mechanism="tree", tree_depth=2), {}, K, 1),
    "grouped": ({}, dict(owner_parallel=True, max_group=2), K, 1),
    "grouped-int8": (dict(bank="int8"), dict(owner_parallel=True, max_group=2), 2 * K, 1),
    "grouped-tree": (dict(mechanism="tree", tree_depth=2), dict(owner_parallel=True), K, 1),
    "faults": (ARMED, PLANS, None, 1),
    "faults-grouped": (ARMED, dict(PLANS, owner_parallel=True), None, 1),
    "faults-tree": (dict(ARMED, mechanism="tree", tree_depth=2), PLANS, None, 1),
    "faults-tree-grouped": (dict(ARMED, mechanism="tree", tree_depth=2),
                            dict(PLANS, owner_parallel=True), None, 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_rounds_no_key_reuse(toy, name):
    fed_kw, run_kw, draws, splits = CASES[name]
    rec, state, ms = _run(_fed(**fed_kw), toy[2], toy[3], **run_kw)
    if draws is not None:
        assert rec.draws == draws
    else:
        # the round draws, the fault codes' and the latencies' (each from a
        # salted fold_in of the dispatch key)
        assert rec.draws == K + 2
    assert rec.splits == splits
    # the tree's deferred commit relaunches tree_delta on the round key: a
    # replay of the first launch's draw, one a round, never a new draw
    assert rec.replays == (K if name.startswith("faults-tree") else 0)


def test_step_loop_no_key_reuse(toy):
    fed = _fed(bank="int8")
    state = fed.init_state(toy[2])
    keys = random.split(random.PRNGKey(7, device=CPU), K)
    with sanitize() as rec:
        for k in range(K):
            state, _ = fed.step(state, {n: v[k] for n, v in toy[3].items()}, SEQ[k], keys[k])
    assert (rec.draws, rec.splits, rec.skipped) == (2 * K, 0, 0)


@pytest.mark.parametrize("fused", [True, False])
def test_sync_driver_no_key_reuse(toy, fused):
    owners = [DataOwner(n=100, epsilon=1.0, xi=1.0) for _ in range(N_OWNERS)]
    fed = Federation(owners, FederationConfig(horizon=8, sigma=1e-2, theta_max=10.0),
                     strategy="sync", device=CPU)
    fed.make_step(_loss, lr=0.1, privatizer=PrivatizerConfig(
        xi=1.0, fused_kernel=fused, n_microbatches=2))
    batches = {k: v[:N_OWNERS] for k, v in toy[3].items()}
    params = toy[2]
    with sanitize() as rec:
        for r in range(2):
            params = fed.sync_round(params, batches,
                                    random.fold_in(random.PRNGKey(1, device=CPU), r))
    # per round: split(key, N), then each owner splits its key over the 2
    # leaves and draws each leaf's noise
    assert (rec.draws, rec.splits, rec.skipped) == (2 * N_OWNERS * 2, 2 * (1 + N_OWNERS), 0)


@pytest.mark.parametrize("strategy", ["async", "sync"])
def test_convex_engine_no_key_reuse(strategy):
    from repro_torch.data import owner_shards
    prob, owners = federate_problem(owner_shards("lending", [500] * 3, seed=0), 1.0,
                                    reg=1e-5, theta_max=2.0, device=CPU)
    fed = Federation(owners, FederationConfig(horizon=50, rho=1.0, sigma=2e-5),
                     strategy=strategy, device=CPU)
    with sanitize() as rec:
        if strategy == "async":
            fed.run(random.PRNGKey(0, device=CPU), prob, n_runs=3)
        else:
            fed.run_sync(random.PRNGKey(0, device=CPU), prob, lr=0.4, n_runs=3)
    assert rec.skipped == 0
    if strategy == "async":
        # split(key, 3 runs), split of each run key; each run's owner
        # sequence (randint) and its T = 50 noise keys' Laplace draws
        assert (rec.draws, rec.splits) == (3 * (1 + 50), 1 + 3 + 3)
    else:
        assert (rec.draws, rec.splits) == (3 * 50, 1)


@pytest.mark.parametrize("fused,bank,grouped", [
    (True, None, False), (False, None, False), (True, "int8", False), (False, "int8", False),
    (True, None, True), (False, None, True)],
    ids=["fused", "unfused", "fused-int8", "unfused-int8", "fused-grouped", "unfused-grouped"])
def test_recorders_agree_with_reference(toy, fused, bank, grouped):
    jparams, jbatches, params, batches = toy
    run_kw = dict(owner_parallel=True, max_group=2) if grouped else {}
    owners = [jfed.DataOwner(n=100, epsilon=1.0, xi=1.0) for _ in range(N_OWNERS)]
    jf = jfed.Federation(owners, jfed.FederationConfig(horizon=8, sigma=1e-2, theta_max=10.0,
                                                       lr_scale=5.0))
    jf.make_step(_jax_loss, privatizer=jfed.PrivatizerConfig(
        xi=1.0, granularity="example", fused_kernel=fused), pack_params=True,
        **({"bank_dtype": bank} if bank else {}))
    state = jf.init_state(jparams)
    with jsanitize() as jrec:
        jf.run_rounds(state, jbatches, jnp.asarray(SEQ, jnp.int32), key=jax.random.PRNGKey(7),
                      **run_kw)
    rec, _, _ = _run(_fed(fused=fused, bank=bank), params, batches, **run_kw)
    assert jrec.skipped == rec.skipped == 0
    if not grouped:
        assert (rec.draws, rec.splits) == (jrec.draws, jrec.splits)
        return
    # one record per member key here, one per vmapped group there; the
    # reference also records its first group's member draws once more, on a
    # () key payload its BatchTracer walk reaches (a unit of its recorder,
    # not a draw of the engine)
    n_groups = len(partition_conflict_free(np.asarray(SEQ), 2))
    per = 1 if fused else 2
    assert rec.draws == K * per and jrec.draws == (n_groups + 1) * per
    assert rec.splits - 1 == (0 if fused else K)
    assert jrec.splits - 1 == (0 if fused else n_groups + 1)


# ------------------------------ the instrument ------------------------------
def test_sanitizer_catches_deliberate_reuse():
    with pytest.raises(KeyReuseError, match="already consumed"):
        with sanitize():
            k = random.PRNGKey(3, device=CPU)
            random.normal(k, (2,))
            random.laplace(k, (2,))


def test_sanitizer_catches_draw_after_split():
    with pytest.raises(KeyReuseError, match="already split"):
        with sanitize():
            k = random.PRNGKey(3, device=CPU)
            random.split(k)
            random.normal(k, (2,))


@pytest.mark.parametrize("first", ["split", "draw"])
def test_sanitizer_catches_double_split(first):
    with pytest.raises(KeyReuseError, match="already split" if first == "split"
                       else "already consumed"):
        with sanitize():
            k = random.PRNGKey(3, device=CPU)
            if first == "split":
                random.split(k)
            else:
                random.bits(k, (3,))
            random.split(k)


def test_sanitizer_allows_fold_in_derivation():
    with sanitize() as rec:
        k = random.PRNGKey(3, device=CPU)
        random.normal(random.fold_in(k, 0), (2,))
        random.normal(random.fold_in(k, 1), (2,))
    assert rec.draws == 2 and rec.skipped == 0


def test_sanitizer_restores_repro_torch_random():
    orig = {n: getattr(random, n) for n in ("normal", "laplace", "bits_range", "split")}
    fold = random.fold_in
    with sanitize():
        assert all(getattr(random, n) is not f for n, f in orig.items())
        assert random.fold_in is fold and random._draw_hook is not None
        with pytest.raises(RuntimeError, match="already active"):
            with sanitize():
                pass
    assert all(getattr(random, n) is f for n, f in orig.items())
    assert random._draw_hook is None
    with pytest.raises(KeyReuseError):
        with sanitize():
            k = random.PRNGKey(3, device=CPU)
            random.bits(k, (2,))
            random.bits(k, (2,))
    assert all(getattr(random, n) is f for n, f in orig.items()) and random._draw_hook is None


@pytest.mark.parametrize("draws,ok", [
    ([("range", 0, 5), ("range", 5, 9)], True),
    ([("range", 0, 5), ("range", 4, 6)], False),
    ([("range", 3, 4), ("full", 3)], False),
    ([("block", (4, 6), (0, 0), (2, 6)), ("block", (4, 6), (2, 0), (2, 6))], True),
    ([("block", (4, 6), (0, 0), (4, 3)), ("block", (4, 6), (0, 3), (4, 3))], True),
    ([("block", (4, 6), (0, 0), (3, 4)), ("block", (4, 6), (2, 3), (2, 3))], False),
    ([("block", (4, 6), (1, 0), (1, 6)), ("range", 6, 12)], False),
    ([("block", (4, 6), (1, 0), (1, 6)), ("range", 12, 24), ("range", 0, 6)], True),
    ([("laplace-block", (4, 6), (0, 0), (2, 6)), ("range", 11, 13)], False),
], ids=["ranges-disjoint", "ranges-overlap", "range-in-full", "row-blocks", "column-blocks",
        "blocks-overlap", "block-vs-range", "block-and-ranges", "sampler-block"])
def test_counter_ranges_of_one_key(draws, ok):
    def go():
        with sanitize() as rec:
            k = random.PRNGKey(3, device=CPU)
            for d in draws:
                if d[0] == "range":
                    random.bits_range(k, d[1], d[2])
                elif d[0] == "full":
                    random.bits(k, (d[1] + 1,))
                elif d[0] == "block":
                    random.bits_block(k, *d[1:])
                else:
                    random.laplace(k, d[1], block=(d[2], d[3]))
        return rec
    if ok:
        assert go().draws == len(draws)
    else:
        with pytest.raises(KeyReuseError, match="already consumed"):
            go()


def test_block_intervals_are_the_block_counters():
    for shape, off, loc in (((4, 6), (2, 3), (2, 3)), ((3, 4, 5), (1, 0, 2), (2, 4, 2)),
                            ((3, 4, 5), (0, 1, 0), (3, 2, 5)), ((8,), (2,), (3,)),
                            ((2, 3), (0, 0), (2, 3)), ((2, 3), (1, 1), (0, 2))):
        idx = np.sort(random._block_counters(shape, off, loc, CPU).numpy())
        iv = block_intervals(shape, off, loc)
        flat = np.concatenate([np.arange(a, b) for a, b in iv] or [np.zeros(0, np.int64)])
        assert np.array_equal(idx, flat) and all(a < b for a, b in iv)


def test_batched_keys_are_checked_row_by_row():
    k = random.PRNGKey(3, device=CPU)
    with sanitize() as rec:
        random.bits_range(random.split(k, 3), 0, 4)
    assert (rec.draws, rec.splits) == (3, 1)
    with pytest.raises(KeyReuseError, match="already consumed"):
        with sanitize():
            ks = random.split(k, 3)
            random.bits(torch.stack([ks[0], ks[1], ks[0]]), (4,))


def test_member_keys_that_repeat_raise_in_dp_round_rows():
    g, p = 3, 10
    tb = torch.zeros((g, p))
    keys = random.split(random.PRNGKey(5, device=CPU), 2)
    kw = dict(sigma=1e-2, lr_own=0.3, lr_l=0.2, n_owners=4, theta_max=2.0)
    ones = torch.ones(g)
    with sanitize() as rec:
        dops.dp_round_rows(tb[:2], tb[:2], keys, ones[:2], ones[:2], ones[:2], **kw)
    assert rec.draws == 2
    with pytest.raises(KeyReuseError, match="already consumed"):
        with sanitize():
            dops.dp_round_rows(tb, tb, keys[torch.tensor([0, 1, 0])], ones, ones, ones, **kw)


def test_replay_must_redraw_what_was_drawn():
    with sanitize() as rec:
        k = random.PRNGKey(3, device=CPU)
        random.bits_range(k, 0, 8)
        with random.replay():
            random.bits_range(k, 2, 6)
        with random.replay():
            random.bits_range(random.fold_in(k, 1), 0, 4)      # never drawn: a draw
    assert (rec.draws, rec.replays) == (2, 1)
    with pytest.raises(KeyReuseError):
        with sanitize():
            k = random.PRNGKey(3, device=CPU)
            with random.replay():
                random.bits_range(k, 0, 4)
            random.bits_range(k, 0, 4)


def test_meta_keys_are_skipped_not_checked():
    with sanitize() as rec:
        k = torch.zeros((3, 2), dtype=torch.uint32, device="meta")
        random.bits(k, (4,))
        random.report_draw("dp_round_flat", k[0], 0, 4)
    assert (rec.draws, rec.skipped) == (0, 4)


def test_report_draw_without_a_sanitizer_touches_nothing():
    calls = []
    k = torch.zeros((2,), dtype=torch.uint32, device="meta")
    assert random._draw_hook is None
    random.report_draw("dp_round_flat", k, 0, 8)          # a meta key: nothing is read
    with sanitize() as rec:
        random._draw_hook = lambda *a: calls.append(a)
        random.report_draw("x", k, 0, 8, fold=3)
        random._draw_hook = rec.report
    assert calls == [("x", k, 0, 8, None, 3)] and rec.draws == 0


def _entry_points(dev):
    """(name, call, key rows) for each kernel entry point that draws, at a
    toy size on `dev`."""
    p, g = 12, 3
    key = random.PRNGKey(11, device=dev)
    keys = random.split(random.fold_in(key, 1), g)
    z = torch.zeros(p, device=dev)
    one = torch.ones((), device=dev)
    kw = dict(sigma=1e-2, lr_own=0.3, lr_l=0.2, n_owners=4, theta_max=2.0)
    nodes = torch.zeros((4, 2, p), device=dev)
    counts = torch.zeros(4, dtype=torch.int32, device=dev)
    owner = torch.zeros(1, dtype=torch.int64, device=dev)
    ns = torch.ones(1, device=dev)
    gs = torch.ones(g, device=dev)
    return [
        ("dp_round_flat", lambda: dops.dp_round_flat(z, z, key, one, one, one, **kw), 1),
        ("dp_round_rows", lambda: dops.dp_round_rows(
            torch.zeros((g, p), device=dev), torch.zeros((g, p), device=dev), keys, gs, gs,
            gs, **kw), g),
        ("scale_noise", lambda: dops.scale_noise(z, key, 1.0, 0.5), 1),
        ("scale_noise-block", lambda: dops.scale_noise(
            torch.zeros((2, 3), device=dev), key, 1.0, 0.5, ((4, 6), (2, 3))), 1),
        ("tree_delta_", lambda: nops.tree_delta_(nodes, counts, owner, key, ns), 1),
        ("tree_delta_rows_", lambda: nops.tree_delta_rows_(
            nodes, counts, torch.arange(g, device=dev), keys, gs), g),
        ("encode_row", lambda: bops.encode_row(z + 0.3, key, "int8"), 1),
    ]


@pytest.mark.parametrize("i", range(7))
def test_each_entry_point_records_one_draw_per_key_on_cpu(i):
    name, call, rows = _entry_points(torch.device(CPU))[i]
    with sanitize() as rec:
        call()
    assert (rec.draws, rec.skipped) == (rows, 0), name
