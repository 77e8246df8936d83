"""The port's flat federation engine on a device mesh, on the CPU.

A mesh is a torch DeviceMesh over a gloo world: a world of one in this
process for the 1x1 mesh, and for the real meshes (2, 2), (4, 1) and
(1, 4) four spawned processes (one spawn per mesh shape, every scenario
run inside it). The unmeshed port is the oracle.

  * 1x1: the meshed engine equals the unmeshed one BIT FOR BIT on the step
    loop, `make_fused_rounds` and `make_group_rounds`, for f32, bf16, int8
    and fp8 banks, the tree at depth 2, the reference mode
    (fused_kernel=False) and fault-armed states (FaultPlan codes, f32,
    int8 and the tree), and on the paged bank; and it equals the
    reference's own 1x1 mesh: refusals and the reconciled ledger exactly,
    theta_L and the bank within the flat engine's parity tolerances.
  * gloo meshes, N = 8 with P = 28 and P = 64, and N = 3 (the data axes
    fold into P): each rank holds exactly its block (`FlatLayout` from
    `flat_shardings`), the blocks put together equal the unmeshed run bit
    for bit (theta_L, bank rows, codes, scales, residual, tree nodes, the
    paged cold tier), and the replicated state (ledger, leaf counts, fault
    columns, metrics, step, the reconciled ledger) is equal on every rank.
  * checkpoints of meshed states (`save_session` gathers the global arrays,
    one rank writes): on every gloo mesh the files equal the unmeshed
    twin's (manifest and arrays, paged cold rows included) and the
    resumed run equals the uninterrupted one; a 2x2 file restores into the
    reference; on the 1x1 mesh a checkpoint crosses the mesh both ways, and
    the ledger checks hold after a meshed restore.
  * per-example clipping (granularity "example"), f16 banks and bf16/f16
    model leaves on every mesh, block for block; int8 and fp8 banks with
    per-block scales (`BankCodec(block_elems=5)`), whose blocks straddle
    the ranks' columns, block for block (codes, scales, residual).
  * `mesh=` on a pytree state raises as in the reference; reconcile,
    LedgerDriftError and the superseded-snapshot error on a meshed state;
    the reference's failing `test_owner_parallel_with_fused_kernel_and_mesh`
    asserted on the port alone.
  * the `col0` plain versions: a slice of a row draws the bits of the
    whole row's columns (dp_round, tree_delta, the codec's encode, and
    random.bits_range), and a sliced row scale equals the whole row's.

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_sharded_engine.py
(the three spawns of four gloo ranks take most of its time).
"""
import datetime
import os
import pickle
import time

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro_torch.federation as tfed
from repro_torch import random as trandom
from repro_torch.convert import params_from_numpy
from repro_torch.federation import PagedBank, QuantBank
from repro_torch.launch.mesh import make_debug_mesh, make_host_mesh, make_production_mesh
from repro_torch.sharding.rules import MeshShape, flat_shardings

CPU = "cpu"
K = 24
RTOL, ATOL = 1e-4, 1e-6
# the fault codes of the fault-armed cases: every outcome once or more
CODES = np.array([0, 0, 3, 0, 4, 0, 0, 2, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 4, 0, 0, 3, 0, 0],
                 np.int8)

# case: (bank_dtype, Federation kwargs, make_step kwargs)
STATES = {
    "f32": (None, {}, {}),
    "bf16": (torch.bfloat16, {}, {}),
    "int8": ("int8", {}, {}),
    "fp8": ("fp8", {}, {}),
    "tree": (None, dict(mechanism="tree", tree_depth=2), {}),
    "unfused": (None, {}, dict(fused=False)),
    "unfused-tree": (None, dict(mechanism="tree", tree_depth=2), dict(fused=False)),
    "faults": (None, dict(faults=True), {}),
    "faults-int8": ("int8", dict(faults=True), {}),
    "faults-tree": (None, dict(faults=True, mechanism="tree", tree_depth=2), {}),
    "faults-staleness": (None, dict(faults=True, staleness=True), {}),
    "f16": (torch.float16, {}, {}),
    # per-example clipping on the fused engine (every rank takes the whole
    # per-example gradients on the gathered theta_bar and keeps its columns)
    "example": (None, {}, dict(gran="example")),
    "example-f16": (torch.float16, {}, dict(gran="example")),
    "example-int8": ("int8", {}, dict(gran="example")),
    "example-tree": (None, dict(mechanism="tree", tree_depth=2), dict(gran="example")),
    "example-faults": (None, dict(faults=True, staleness=True), dict(gran="example")),
    # bf16 and f16 model leaves on an f16 bank
    "example-mixed": (torch.float16, {}, dict(gran="example", mixed=True)),
    # per-block scales (blocks of 5: on P = 28 the blocks [10, 15) and
    # [25, 28) straddle the column blocks of 2 and 4 ranks)
    "int8-block": (tfed.BankCodec("int8", block_elems=5), {}, {}),
    "fp8-block": (tfed.BankCodec("fp8", block_elems=5), {}, {}),
}
EXAMPLE_STATES = ("f16", "example", "example-f16", "example-int8", "example-tree",
                  "example-faults", "example-mixed")
DRIVERS = ("fused", "grouped", "step")
# toy shapes: N owners and the (w, b) leaves giving P = 28 or P = 64
SHAPES = {"N8-P28": (8, (6, 4)), "N8-P64": (8, (15, 4)), "N3-P28": (3, (6, 4))}


def _toy(shape: str, mixed: bool = False):
    n, (d_in, d_out) = SHAPES[shape]
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((d_in, d_out)).astype(np.float32),
              "b": np.zeros(d_out, np.float32)}
    if mixed:
        params = {"w": params["w"].astype(ml_dtypes.bfloat16), "b": params["b"].astype(np.float16)}
    data = {"x": rng.standard_normal((K, 4, d_in)).astype(np.float32),
            "y": rng.standard_normal((K, 4, d_out)).astype(np.float32)}
    seq = rng.integers(0, n, K).astype(np.int32)
    return n, params, data, seq


def _loss(p, b):
    return torch.mean((b["x"] @ p["w"].float() + p["b"].float() - b["y"]) ** 2)


def _fed(n, state, mesh=None, horizon=3, pack=True):
    bank_dtype, fkw, skw = STATES[state]
    fkw = dict(fkw)
    if fkw.pop("faults", False):
        fkw["fault_policy"] = tfed.FaultPolicy(max_faults=2, window=8)
    if fkw.pop("staleness", False):
        fkw["staleness"] = tfed.StalenessPolicy(deadline=1.0, max_retries=2, decay=0.9)
    fed = tfed.Federation([tfed.DataOwner(n=100 * (1 + i % 3), epsilon=1.0, xi=1.0)
                           for i in range(n)],
                          tfed.FederationConfig(horizon=horizon, sigma=1e-2, theta_max=10.0,
                                                lr_scale=5.0), device=CPU, **fkw)
    priv = tfed.PrivatizerConfig(xi=1.0, granularity=skw.get("gran", "microbatch"),
                                 n_microbatches=2, fused_kernel=skw.get("fused", True))
    fed.make_step(_loss, privatizer=priv, pack_params=pack,
                  bank_dtype=bank_dtype if pack else None, mesh=mesh)
    return fed


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _bank_arrays(bank):
    if isinstance(bank, PagedBank):
        out = _bank_arrays(bank.hot)
        out["hot_ids"] = _np(bank.hot_ids)
        return out
    if isinstance(bank, QuantBank):
        return {"codes": _np(bank.codes), "scales": _np(bank.scales),
                "residual": _np(bank.residual)}
    return {"rows": _np(bank)}


def _result(fed, st, metrics, paged):
    """A scenario's numpy results: this rank's blocks (theta columns, bank
    rows x columns, tree nodes), the layout of its block, and the
    replicated state (ledger, counts, fault columns, metrics, step,
    reconciled ledger)."""
    lay = st.theta_L.layout
    n = fed.n_owners
    out = {"theta": _np(st.theta_L.buf), "bank": _bank_arrays(st.bank), "metrics": metrics,
           "step": int(st.step), "ledger": {c: _np(getattr(st.ledger, c))
                                            for c in st.ledger.COLUMNS},
           "reconciled": fed.reconcile(st),
           "rows": (0, 4 if paged else n) if lay is None else (lay.r0, lay.n_local),
           "cols": (0, st.theta_L.size) if lay is None else (lay.c0, lay.p_local)}
    if st.tree is not None:
        out["nodes"] = _np(st.tree.nodes)
        out["counts"] = _np(st.tree.counts)
    if st.faults is not None:
        out["faults"] = [_np(t) for t in st.faults]
    if st.stale is not None:
        out["stale"] = [_np(t) for t in st.stale]
    if paged:
        out["cold"] = fed.pager.snapshot(st)
    return out


def _inputs(shape, state):
    n, params, data, seq = _toy(shape, STATES[state][2].get("mixed", False))
    return n, params_from_numpy(params, device=CPU), \
        {k: torch.from_numpy(v) for k, v in data.items()}, seq


def run_case(shape: str, state: str, driver: str, mesh=None, paged: bool = False):
    """One scenario -> `_result`'s dict. mesh=None runs the unmeshed port."""
    n, p, batches, seq = _inputs(shape, state)
    fed = _fed(n, state, mesh)
    st = fed.init_paged_state(p, n_hot=4) if paged else fed.init_state(p)
    key = trandom.PRNGKey(4, device=CPU)
    faults = STATES[state][1].get("faults", False)
    if driver == "step":
        mets = []
        for k, kk in enumerate(trandom.split(key, K)):
            st, m = fed.step(st, {a: v[k] for a, v in batches.items()}, int(seq[k]), kk,
                             fault_code=int(CODES[k]) if faults else None)
            mets.append(m)
        metrics = {"refused": np.array([bool(m["refused"]) for m in mets]),
                   "owner": np.array([int(m["owner"]) for m in mets])}
    elif paged:
        metrics = {}
        for d in range(K // 4):                       # dispatches of 4 rounds, <= 4 owners
            sl = slice(4 * d, 4 * d + 4)
            st, m = fed.run_rounds(st, {a: v[sl] for a, v in batches.items()}, seq[sl],
                                   key=trandom.PRNGKey(10 + d, device=CPU),
                                   owner_parallel=driver == "grouped")
            for name, v in m.items():
                metrics.setdefault(name, []).append(_np(v))
        metrics = {name: np.concatenate(v) for name, v in metrics.items()}
    else:
        kw = dict(faults=torch.from_numpy(CODES)) if faults else {}
        st, m = fed.run_rounds(st, batches, seq, key=key, owner_parallel=driver == "grouped",
                               **kw)
        metrics = {name: _np(v) for name, v in m.items()}
    return _result(fed, st, metrics, paged)


def run_checkpoint(shape: str, state: str, directory: str, mesh=None, paged: bool = False):
    """Crash-resume on a (meshed) state: three dispatches of 4 rounds
    (sequential, grouped, sequential), `save_session` into `directory`,
    three more uninterrupted; then a fresh session restores the checkpoint
    and runs the same three. -> (`_result` of the uninterrupted run, of the
    resumed run)."""
    n, p, batches, seq = _inputs(shape, state)
    faults = STATES[state][1].get("faults", False)

    def session():
        fed = _fed(n, state, mesh, horizon=6)
        return fed, (fed.init_paged_state(p, n_hot=4) if paged else fed.init_state(p))

    def dispatch(fed, st, d):
        sl = slice(4 * d, 4 * d + 4)
        kw = dict(faults=torch.from_numpy(CODES[sl])) if faults else {}
        return fed.run_rounds(st, {a: v[sl] for a, v in batches.items()}, seq[sl],
                              key=trandom.PRNGKey(40 + d, device=CPU),
                              owner_parallel=d % 2 == 1, **kw)[0]

    fed, st = session()
    for d in range(3):
        st = dispatch(fed, st, d)
    fed.reconcile(st)
    fed.save_session(directory, st)
    for d in range(3, 6):
        st = dispatch(fed, st, d)
    whole = _result(fed, st, {}, paged)
    fed, like = session()
    st = fed.restore_session(directory, like)
    for d in range(3, 6):
        st = dispatch(fed, st, d)
    return whole, _result(fed, st, {}, paged)


# scenarios of the gloo meshes: every state and driver at N 8 / P 28, the
# paged bank, and a subset at the other two shapes
GLOO_CASES = ([("N8-P28", s, d, False) for s in STATES for d in ("fused", "grouped")]
              + [("N8-P28", s, "step", False) for s in ("f32", "int8", "faults")]
              + [("N8-P28", s, d, True) for s in ("f32", "int8", "tree")
                 for d in ("fused", "grouped")]
              + [(sh, s, d, False) for sh in ("N8-P64", "N3-P28")
                 for s in ("f32", "bf16", "int8", "tree", "faults", "unfused")
                 for d in ("fused", "grouped")]
              + [("N8-P28", s, "step", False) for s in ("example", "example-faults")]
              + [("N8-P28", s, d, True) for s in ("example", "example-int8", "example-tree")
                 for d in ("fused", "grouped")]
              + [(sh, s, d, False) for sh in ("N8-P64", "N3-P28") for s in ("example", "f16")
                 for d in ("fused", "grouped")])
GLOO_MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
# the piece size of the gloo meshes' saves, under one row of any leaf: a
# piece is then one row, the largest a tree node's d * P = 2 * 28 f32
CKPT_PIECE_BYTES = 64
CKPT_ROW_BYTES = 2 * 28 * 4
# checkpoints of meshed states: (shape, state, paged)
CKPT_CASES = (("N8-P28", "f32", False), ("N8-P28", "example-int8", False),
              ("N8-P28", "example-tree", False), ("N8-P28", "example-faults", False),
              ("N8-P28", "example-mixed", False), ("N8-P28", "f16", True),
              ("N8-P28", "example-int8", True), ("N3-P28", "bf16", False))


def _case_id(case):
    shape, state, driver, paged = case
    return f"{shape}-{state}-{driver}" + ("-paged" if paged else "")


def _ckpt_id(case):
    shape, state, paged = case
    return f"{shape}-{state}" + ("-paged" if paged else "")


def _worker(rank, world, mesh_shape, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_debug_mesh(*mesh_shape, device_type=CPU)
        results = {}
        for case in GLOO_CASES:
            shape, state, driver, paged = case
            results[_case_id(case)] = run_case(shape, state, driver, mesh, paged)
        # the meshed saves in pieces of one row: every block reaches the
        # writer over several sends; record what each rank holds and moves
        from repro_torch.checkpoint import store as cstore
        from repro_torch.sharding.flat import FlatLayout
        cstore.PIECE_BYTES = CKPT_PIECE_BYTES
        moved = {"yielded": [], "sent": []}
        stream, send = FlatLayout.stream, dist.send

        def recorded_stream(self, *a, **kw):
            for piece in stream(self, *a, **kw):
                moved["yielded"].append(piece.numel() * piece.element_size())
                yield piece

        def recorded_send(t, *a, **kw):
            moved["sent"].append(t.numel() * t.element_size())
            return send(t, *a, **kw)
        FlatLayout.stream, dist.send = recorded_stream, recorded_send
        for case in CKPT_CASES:
            shape, state, paged = case
            results["ckpt/" + _ckpt_id(case)] = run_checkpoint(
                shape, state, os.path.join(out_dir, "ckpt", _ckpt_id(case)), mesh, paged)
        FlatLayout.stream, dist.send = stream, send
        results["ckpt-moved"] = moved
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _spawn(mesh_shape, tmp):
    world = mesh_shape[0] * mesh_shape[1]
    ctx = mp.start_processes(_worker, args=(world, mesh_shape, str(tmp / "store"), str(tmp)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {mesh_shape} gloo mesh did not finish in 600 s")
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module", params=list(GLOO_MESHES))
def gloo_run(request, tmp_path_factory):
    name = request.param
    tmp = tmp_path_factory.mktemp(f"gloo{name}")
    return name, _spawn(GLOO_MESHES[name], tmp), tmp


@pytest.fixture(scope="module")
def unmeshed():
    cache = {}

    def get(case):
        if case not in cache:
            torch.set_num_threads(1)
            cache[case] = run_case(case[0], case[1], case[2], None, case[3])
        return cache[case]
    return get


def _assemble(ranks, key, want):
    """Put the ranks' blocks of `key` together into an array shaped as the
    unmeshed `want`; ranks holding the same block must agree bit for bit."""
    full = np.full(want.shape, np.nan, np.float64) if want.dtype.kind == "f" else None
    got = np.zeros_like(want) if full is None else full
    seen = np.zeros(want.shape, bool)
    for res in ranks:
        block = _pick(res, key)
        (r0, nr), (c0, nc) = res["rows"], res["cols"]
        idx = _block_index(key, want.ndim, r0, nr, c0, nc)
        prev = got[idx]
        if seen[idx].any():
            np.testing.assert_array_equal(prev.astype(want.dtype), block, err_msg=key)
        got[idx] = block
        seen[idx] = True
    assert seen.all(), f"{key}: the blocks do not cover the array"
    return got.astype(want.dtype)


def _pick(res, key):
    if key in ("theta",):
        return res["theta"]
    if key == "nodes":
        return res["nodes"]
    if key.startswith("cold/"):
        return res["cold"][key[5:]]
    return res["bank"][key]


def _block_index(key, ndim, r0, nr, c0, nc):
    rows, cols = slice(r0, r0 + nr), slice(c0, c0 + nc)
    if key in ("theta", "residual"):
        return (cols,)
    if key == "scales":
        return (rows, slice(None))
    if key == "hot_ids":
        return (slice(None),)
    if key == "nodes":
        return (rows, slice(None), cols)
    if key.startswith("cold/"):
        return (slice(None),) * (ndim - 1) + (cols,) if key != "cold/scales" else \
            (slice(None),) * ndim
    return (rows, cols)


@pytest.mark.parametrize("case", GLOO_CASES, ids=[_case_id(c) for c in GLOO_CASES])
def test_gloo_mesh_blocks_equal_the_unmeshed_run(gloo_run, unmeshed, case):
    name, ranks, _ = gloo_run
    want = unmeshed(case)
    _assert_blocks_equal(name, [r[_case_id(case)] for r in ranks], want, case[0], case[3])


def _assert_blocks_equal(name, res, want, shape, paged):
    """Each rank holds exactly its block, the blocks put together equal the
    unmeshed `want` bit for bit, and the replicated state is `want`'s on
    every rank."""
    n = SHAPES[shape][0]
    n_rows = 4 if paged else n
    p = want["theta"].shape[0]
    spec = flat_shardings(MeshShape(GLOO_MESHES[name], ("data", "model")), n_rows, p)
    for r in res:
        # each rank holds exactly its block of the layout the rules give
        (r0, nr), (c0, nc) = r["rows"], r["cols"]
        assert r["theta"].shape == (nc,)
        for k, v in r["bank"].items():
            if k in ("rows", "codes"):
                assert v.shape == (nr, nc), k
        if spec.bank.spec[0] is not None:
            assert nr < n_rows
        if spec.bank.spec[1] is not None:
            assert nc < p
    np.testing.assert_array_equal(_assemble(res, "theta", want["theta"]), want["theta"])
    for k, v in want["bank"].items():
        np.testing.assert_array_equal(_assemble(res, k, v), v, err_msg=k)
    if "nodes" in want:
        np.testing.assert_array_equal(_assemble(res, "nodes", want["nodes"]), want["nodes"])
    for k, v in want.get("cold", {}).items():
        np.testing.assert_array_equal(_assemble(res, f"cold/{k}", v), v, err_msg=k)
    # the replicated state: equal to the unmeshed run's on every rank
    for r in res:
        assert r["step"] == want["step"]
        assert r["reconciled"] == want["reconciled"]
        for c, v in want["ledger"].items():
            np.testing.assert_array_equal(r["ledger"][c], v, err_msg=c)
        for k, v in want["metrics"].items():
            np.testing.assert_array_equal(r["metrics"][k], v, err_msg=k)
        for field in ("counts",):
            if field in want:
                np.testing.assert_array_equal(r[field], want[field])
        for field in ("faults", "stale"):
            for a, b in zip(r.get(field, []), want.get(field, [])):
                np.testing.assert_array_equal(a, b, err_msg=field)


# ------------------------------------ meshed checkpoints ---------------------------------
@pytest.fixture(scope="module")
def unmeshed_ckpt(tmp_path_factory):
    cache = {}

    def get(case):
        if case not in cache:
            d = str(tmp_path_factory.mktemp("ckpt-" + _ckpt_id(case)))
            torch.set_num_threads(1)
            cache[case] = (d, run_checkpoint(case[0], case[1], d, None, case[2]))
        return cache[case]
    return get


def _checkpoint_files(directory):
    """(manifest, {npz key: array}) of the newest checkpoint under it."""
    from repro_torch.checkpoint import latest_step, load_manifest
    step = latest_step(directory)
    with np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as z:
        return load_manifest(directory, step), {k: z[k] for k in z.files}


def _assert_files_equal(a, b):
    (ma, aa), (mb, ab) = a, b
    assert ma == mb                      # keys, dtypes, shapes, aux, journal, paging
    assert list(aa) == list(ab)
    for k in ab:
        assert aa[k].dtype == ab[k].dtype, k
        np.testing.assert_array_equal(aa[k], ab[k], err_msg=k)


@pytest.mark.parametrize("case", CKPT_CASES, ids=[_ckpt_id(c) for c in CKPT_CASES])
def test_gloo_mesh_checkpoint_is_the_unmeshed_twins(gloo_run, unmeshed_ckpt, case):
    """`save_session` on a gloo mesh (every rank calls it, the lowest rank
    writes the gathered global arrays) writes the files of the unmeshed
    twin: the manifest and every array (the paged cold rows included) bit
    for bit, so the file loads unmeshed and the twin's file on the mesh.
    `restore_session` on the mesh resumes bit for bit as the uninterrupted
    meshed run, and both equal the twin's runs block for block."""
    name, ranks, tmp = gloo_run
    twin_dir, (twin_whole, twin_resumed) = unmeshed_ckpt(case)
    _assert_files_equal(_checkpoint_files(str(tmp / "ckpt" / _ckpt_id(case))),
                        _checkpoint_files(twin_dir))
    _assert_results_equal(twin_resumed, twin_whole)
    res = [r["ckpt/" + _ckpt_id(case)] for r in ranks]
    for whole, resumed in res:
        _assert_results_equal(resumed, whole)
    _assert_blocks_equal(name, [r[1] for r in res], twin_resumed, case[0], case[2])


def test_gloo_mesh_saves_hold_no_global_array(gloo_run):
    """A meshed save moves each block to the writer a piece at a time: the
    writer (rank 0) holds one piece of a global array at once, of one row
    here, and the other ranks hold none, sending pieces of their own
    blocks no larger."""
    name, ranks, _ = gloo_run
    moved = [r["ckpt-moved"] for r in ranks]
    assert moved[0]["yielded"] and max(moved[0]["yielded"]) <= CKPT_ROW_BYTES
    assert not moved[0]["sent"]
    assert any(m["sent"] for m in moved[1:])
    for m in moved[1:]:
        assert not m["yielded"] and max(m["sent"], default=0) <= CKPT_ROW_BYTES


def _ref_fed(state, n, horizon):
    import jax.numpy as jnp
    import repro.federation as jfed
    bank_dtype, fkw, skw = STATES[state]
    assert not fkw and not skw.get("mixed")
    jf = jfed.Federation([jfed.DataOwner(n=100 * (1 + i % 3), epsilon=1.0, xi=1.0)
                          for i in range(n)],
                         jfed.FederationConfig(horizon=horizon, sigma=1e-2, theta_max=10.0,
                                               lr_scale=5.0))
    jf.make_step(lambda p, b: jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2),
                 privatizer=jfed.PrivatizerConfig(xi=1.0, granularity=skw.get("gran",
                                                                              "microbatch"),
                                                  n_microbatches=2, fused_kernel=True),
                 pack_params=True, bank_dtype=bank_dtype)
    return jf


@pytest.mark.parametrize("case", [c for c in CKPT_CASES if c[1] in ("f32", "example-int8")
                                  and not c[2]], ids=_ckpt_id)
def test_gloo_mesh_checkpoint_loads_into_the_reference(gloo_run, case):
    """A checkpoint written on a gloo mesh restores into the reference's
    unmeshed state: every leaf bit for bit the global array, the journal
    replayed."""
    import jax.numpy as jnp
    from repro.checkpoint.store import _flatten_with_paths
    _, _, tmp = gloo_run
    directory = str(tmp / "ckpt" / _ckpt_id(case))
    manifest, arrays = _checkpoint_files(directory)
    n, params, _, _ = _toy(case[0])
    jf = _ref_fed(case[1], n, horizon=6)
    js = jf.restore_session(directory, jf.init_state({k: jnp.asarray(v)
                                                      for k, v in params.items()}))
    leaves = _flatten_with_paths(js)
    assert list(leaves) == manifest["keys"]
    for k, leaf in leaves.items():
        np.testing.assert_array_equal(np.asarray(leaf), arrays[k.replace("/", "__SL__")],
                                      err_msg=k)
    assert jf.mechanism.export_journal() == manifest["extra"]["journal"]
    assert int(js.step) == manifest["step"]


# ------------------------------------------ 1x1 in this process --------------------------
@pytest.fixture(scope="module")
def host_mesh():
    return make_host_mesh(device_type=CPU)


ONE_BY_ONE = ([("N8-P28", s, d, False) for s in STATES for d in DRIVERS]
              + [("N8-P28", s, d, True) for s in ("f32", "bf16", "int8", "tree", "faults")
                 for d in ("fused", "grouped")])


@pytest.mark.parametrize("case", ONE_BY_ONE, ids=[_case_id(c) for c in ONE_BY_ONE])
def test_one_by_one_mesh_is_bit_exact(host_mesh, unmeshed, case):
    torch.set_num_threads(1)
    _assert_results_equal(run_case(case[0], case[1], case[2], host_mesh, case[3]),
                          unmeshed(case))


def _assert_results_equal(got, want):
    """Two `_result`s of the same block equal bit for bit."""
    np.testing.assert_array_equal(got["theta"], want["theta"])
    assert got["bank"].keys() == want["bank"].keys()
    for k in want["bank"]:
        np.testing.assert_array_equal(got["bank"][k], want["bank"][k], err_msg=k)
    for k in ("nodes", "counts"):
        if k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for k in ("faults", "stale"):
        for a, b in zip(got.get(k, []), want.get(k, [])):
            np.testing.assert_array_equal(a, b)
    for k in want["metrics"]:
        np.testing.assert_array_equal(got["metrics"][k], want["metrics"][k], err_msg=k)
    for k in want.get("cold", {}):
        np.testing.assert_array_equal(got["cold"][k], want["cold"][k], err_msg=k)
    assert got["reconciled"] == want["reconciled"] and got["step"] == want["step"]


def test_one_by_one_layout_and_collectives(host_mesh):
    """The 1x1 layout holds the whole state, its groups are the rank alone,
    and every collective still runs (a gather is a copy, a -0.0 stays)."""
    from repro_torch.sharding.flat import layout_for
    lay = layout_for(host_mesh, 8, 28)
    assert (lay.r0, lay.n_local, lay.c0, lay.p_local) == (0, 8, 0, 28)
    x = torch.tensor([[-0.0, 1.5, float("nan")]])
    got = lay.pick(x, torch.tensor([5]))
    assert torch.equal(torch.signbit(got), torch.signbit(x)) and torch.isnan(got[0, 2])
    assert torch.isnan(lay.max_cols(torch.tensor([float("nan"), 1.0])))[0]
    assert int(lay.sum_cols(torch.tensor(2 ** 40, dtype=torch.int64))) == 2 ** 40
    assert bool(lay.all_cols(torch.tensor(True))) and not bool(lay.all_cols(torch.tensor(False)))
    assert torch.equal(lay.gather_cols(torch.arange(28.0)), torch.arange(28.0))


def test_production_mesh_needs_the_ranks(host_mesh):
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        make_production_mesh(device_type=CPU)
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        make_production_mesh(multi_pod=True, device_type=CPU)
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(model=2, device_type=CPU)
    assert tuple(make_debug_mesh(1, 1, device_type=CPU).mesh_dim_names) == ("data", "model")


def test_mesh_requires_flat_engine(host_mesh):
    n, params, _, _ = _toy("N8-P28")
    fed = tfed.Federation([tfed.DataOwner(n=100, epsilon=1.0, xi=1.0)] * n,
                          tfed.FederationConfig(horizon=3, sigma=1e-2), device=CPU)
    with pytest.raises(ValueError, match="flat-engine option"):
        fed.make_step(_loss, mesh=host_mesh)
    fed.make_step(_loss)
    with pytest.raises(ValueError, match="flat-engine option"):
        fed.init_state(params_from_numpy(params, device=CPU), mesh=host_mesh)


def test_driver_on_a_mesh_refuses_an_unmeshed_state(host_mesh):
    n, params, data, seq = _toy("N8-P28")
    fed = _fed(n, "f32", host_mesh)
    st = fed.init_state(params_from_numpy(params, device=CPU))
    assert st.theta_L.layout is not None
    plain = _fed(n, "f32")
    bare = plain.init_state(params_from_numpy(params, device=CPU))
    with pytest.raises(ValueError, match="not laid out"):
        fed.run_rounds(bare, {k: torch.from_numpy(v) for k, v in data.items()}, seq,
                       key=trandom.PRNGKey(0, device=CPU))


@pytest.mark.parametrize("state", ("f32", "example-int8", "example-mixed"))
def test_one_by_one_checkpoints_cross_the_mesh_both_ways(host_mesh, tmp_path, state):
    """A 1x1-mesh checkpoint is the unmeshed twin's (manifest and arrays);
    it restores unmeshed, the unmeshed one restores on the mesh, and each
    resumed run equals the uninterrupted one bit for bit."""
    torch.set_num_threads(1)
    whole_m, resumed_m = run_checkpoint("N8-P28", state, str(tmp_path / "m"), host_mesh)
    whole_u, resumed_u = run_checkpoint("N8-P28", state, str(tmp_path / "u"))
    _assert_files_equal(_checkpoint_files(str(tmp_path / "m")),
                        _checkpoint_files(str(tmp_path / "u")))
    for got in (resumed_m, whole_u, resumed_u):
        _assert_results_equal(got, whole_m)
    n, p, batches, seq = _inputs("N8-P28", state)
    for src, mesh in (("u", host_mesh), ("m", None)):
        fed = _fed(n, state, mesh, horizon=6)
        st = fed.restore_session(str(tmp_path / src), fed.init_state(p))
        assert (st.theta_L.layout is not None) == (mesh is not None)
        for d in range(3, 6):
            sl = slice(4 * d, 4 * d + 4)
            st, _ = fed.run_rounds(st, {a: v[sl] for a, v in batches.items()}, seq[sl],
                                   key=trandom.PRNGKey(40 + d, device=CPU),
                                   owner_parallel=d % 2 == 1)
        _assert_results_equal(_result(fed, st, {}, False), whole_m)


def test_meshed_restore_keeps_the_ledger_checks(host_mesh, tmp_path):
    """After a meshed restore the restored ledger folds exactly once, host
    spending behind a stale device ledger is drift, and a newer snapshot
    supersedes a restored state."""
    n, params, data, _ = _toy("N8-P28")
    p = params_from_numpy(params, device=CPU)
    b = {k: torch.from_numpy(v[:2]) for k, v in data.items()}
    b0 = {k: v[0] for k, v in b.items()}
    fed = _fed(n, "f32", host_mesh, horizon=4)
    st, _ = fed.run_rounds(fed.init_state(p), b, np.zeros(2, np.int32),
                           key=trandom.PRNGKey(1, device=CPU))
    fed.save_session(str(tmp_path), st)                    # not reconciled: 2 spent
    fed2 = _fed(n, "f32", host_mesh, horizon=4)
    restored = fed2.restore_session(str(tmp_path), fed2.init_state(p))
    assert restored.theta_L.layout is not None
    led = fed2.reconcile(restored)
    assert led[0]["responses"] == 2 and led[0]["refused"] == 0
    assert fed2.reconcile(restored) == led                 # idempotent
    for _ in range(2):                                     # spend the rest on the host
        restored, m = fed2.step(restored, b0, 0, trandom.PRNGKey(2, device=CPU))
        assert not m["refused"]
    restored, ms = fed2.run_rounds(restored, b, np.zeros(2, np.int32),
                                   key=trandom.PRNGKey(3, device=CPU))
    assert not _np(ms["refused"]).any()                    # the stale device ledger grants
    with pytest.raises(tfed.LedgerDriftError, match="stale"):
        fed2.reconcile(restored)
    fed3 = _fed(n, "f32", host_mesh, horizon=4)
    old = fed3.restore_session(str(tmp_path), fed3.init_state(p))
    fed3.init_state(p)                                     # a newer snapshot supersedes it
    with pytest.raises(tfed.LedgerDriftError, match="superseded"):
        fed3.reconcile(old)


def test_sharded_reconcile_folds_bit_exactly_and_detects_drift(host_mesh):
    n, params, data, _ = _toy("N8-P28")
    p = params_from_numpy(params, device=CPU)
    b0 = {k: torch.from_numpy(v[0]) for k, v in data.items()}
    key = trandom.PRNGKey(0, device=CPU)
    fed = _fed(n, "f32", host_mesh, horizon=2)
    state = fed.init_state(p)
    for _ in range(2):                        # spend owner 0's cap on the host
        state, m = fed.step(state, b0, 0, key)
        assert not m["refused"]
    led = fed.reconcile(state)
    assert led[0]["responses"] == 2 and led[0]["exhausted"]
    fed2 = _fed(n, "f32", host_mesh, horizon=2)
    st2 = fed2.init_state(p)
    for _ in range(2):
        st2, _ = fed2.step(st2, b0, 0, key)
    st2, ms = fed2.run_rounds(st2, {k: torch.from_numpy(v[:2]) for k, v in data.items()},
                              np.zeros(2, np.int32), key=trandom.PRNGKey(1, device=CPU))
    assert not _np(ms["refused"]).any()       # the stale device ledger grants
    with pytest.raises(tfed.LedgerDriftError, match="stale"):
        fed2.reconcile(st2)


def test_sharded_superseded_snapshot_cannot_reconcile(host_mesh):
    n, params, data, _ = _toy("N8-P28")
    p = params_from_numpy(params, device=CPU)
    fed = _fed(n, "f32", host_mesh)

    def sub(k):
        return {a: torch.from_numpy(v[:k]) for a, v in data.items()}
    state_a = fed.init_state(p)
    state_a, _ = fed.run_rounds(state_a, sub(8), np.zeros(8, np.int32),
                                key=trandom.PRNGKey(1, device=CPU))
    state_b = fed.init_state(p)               # supersedes state_a
    state_b, _ = fed.run_rounds(state_b, sub(4), np.zeros(4, np.int32),
                                key=trandom.PRNGKey(2, device=CPU))
    led = fed.reconcile(state_b)
    assert led[0]["responses"] == 3 and led[0]["refused"] == 1
    with pytest.raises(tfed.LedgerDriftError, match="superseded"):
        fed.reconcile(state_a)


def test_owner_parallel_with_fused_kernel_and_mesh(host_mesh):
    """The reference's production-stack case, on the port alone: the fused
    engine, a bf16 bank, the host mesh and the grouped driver; 8 grants,
    and 2 responses and 4 refusals for each of the 4 owners."""
    n, params, data, _ = _toy("N8-P28")
    fed = tfed.Federation([tfed.DataOwner(n=100, epsilon=1.0, xi=1.0) for _ in range(n)],
                          tfed.FederationConfig(horizon=2, sigma=1e-2, theta_max=10.0,
                                                lr_scale=5.0), device=CPU)
    priv = tfed.PrivatizerConfig(xi=1e-3, granularity="microbatch", n_microbatches=2,
                                 fused_kernel=True)
    fed.make_step(_loss, privatizer=priv, pack_params=True, mesh=host_mesh,
                  bank_dtype=torch.bfloat16)
    seq = np.arange(K) % 4
    s, ms = fed.run_rounds(fed.init_state(params_from_numpy(params, device=CPU)),
                           {k: torch.from_numpy(v) for k, v in data.items()}, seq,
                           key=trandom.PRNGKey(6, device=CPU), owner_parallel=True)
    assert s.bank.dtype == torch.bfloat16
    assert np.isfinite(_np(s.theta_L.buf)).all()
    assert (~_np(ms["refused"]).astype(bool)).sum() == 8
    led = fed.reconcile(s)
    assert all(led[i]["responses"] == 2 and led[i]["refused"] == 4 for i in range(4))


# ----------------------------------- against the reference's 1x1 mesh ---------------------
REF_STATES = ("f32", "bf16", "int8", "tree", "unfused")


def _ref_run(state, driver, mesh=False, granularity="microbatch"):
    import jax
    import jax.numpy as jnp
    import repro.federation as jfed
    from repro.launch.mesh import make_host_mesh as jax_host_mesh

    n, params, data, seq = _toy("N8-P28")
    bank_dtype, fkw, skw = STATES[state]
    jf = jfed.Federation([jfed.DataOwner(n=100 * (1 + i % 3), epsilon=1.0, xi=1.0)
                          for i in range(n)],
                         jfed.FederationConfig(horizon=3, sigma=1e-2, theta_max=10.0,
                                               lr_scale=5.0), **fkw)
    priv = jfed.PrivatizerConfig(xi=1.0, granularity=granularity, n_microbatches=2,
                                 fused_kernel=skw.get("fused", True))
    jf.make_step(lambda p, b: jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2),
                 privatizer=priv, pack_params=True,
                 bank_dtype=jnp.bfloat16 if bank_dtype is torch.bfloat16 else bank_dtype,
                 mesh=jax_host_mesh(model=1) if mesh else None)
    js = jf.init_state({k: jnp.asarray(v) for k, v in params.items()})
    js, jm = jf.run_rounds(js, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(seq),
                           key=jax.random.PRNGKey(4), owner_parallel=driver == "grouped")
    return jf, js, {k: np.asarray(v) for k, v in jm.items()}


def _ledger_parity(got, want):
    for i, row in got.items():
        assert row == {k: want[i][k] for k in row}, i


@pytest.mark.parametrize("driver", ["fused", "grouped"])
@pytest.mark.parametrize("state", REF_STATES)
def test_one_by_one_mesh_matches_the_reference(host_mesh, state, driver):
    """The port's 1x1 mesh against the reference. Under jax 0.9 the
    reference's own mesh path runs only its sequential fused engine with
    per-example clipping (with per-microbatch clipping, in its reference
    mode and under its grouped driver it raises a sharding error, which
    is what fails its test_owner_parallel_with_fused_kernel_and_mesh); its
    1x1 mesh equals its unmeshed engine bit for bit
    (test_sharded_engine.py::test_one_by_one_mesh_is_bit_exact). So the
    refusal pattern, the owners and the reconciled ledger are held against
    the reference's 1x1 mesh where it runs (they do not depend on the
    clipping), and everything, theta_L and the bank within the flat
    engine's tolerances, against the reference's unmeshed run of the same
    configuration."""
    got = run_case("N8-P28", state, driver, host_mesh)
    if driver == "fused" and state != "unfused":
        jf, js, jm = _ref_run(state, driver, mesh=True, granularity="example")
        np.testing.assert_array_equal(got["metrics"]["refused"], jm["refused"])
        np.testing.assert_array_equal(got["metrics"]["owner"], jm["owner"])
        _ledger_parity(got["reconciled"], jf.reconcile(js))
    jf, js, jm = _ref_run(state, driver)
    np.testing.assert_array_equal(got["metrics"]["refused"], jm["refused"])
    np.testing.assert_array_equal(got["metrics"]["owner"], jm["owner"])
    _ledger_parity(got["reconciled"], jf.reconcile(js))
    np.testing.assert_allclose(got["theta"], np.asarray(js.theta_L.buf), rtol=RTOL, atol=ATOL)
    bank_dtype = STATES[state][0]
    if bank_dtype == "int8":
        codes = np.asarray(js.bank.codes).astype(np.int64)
        assert np.abs(got["bank"]["codes"].astype(np.int64) - codes).max() <= 1
    elif bank_dtype is torch.bfloat16:
        np.testing.assert_allclose(got["bank"]["rows"], np.asarray(js.bank, np.float32),
                                   rtol=2 ** -7, atol=ATOL)
    else:
        np.testing.assert_allclose(got["bank"]["rows"], np.asarray(js.bank), rtol=RTOL,
                                   atol=ATOL)
    if "nodes" in got:
        np.testing.assert_allclose(got["nodes"], np.asarray(js.tree.nodes), rtol=RTOL,
                                   atol=ATOL)


def test_paged_engine_on_1x1_mesh_bit_exact(host_mesh):
    """The reference's paged 1x1 case: n_hot = N, flat vs paged on the
    mesh, bit for bit."""
    n, params, data, seq = _toy("N8-P28")
    p = params_from_numpy(params, device=CPU)
    batches = {k: torch.from_numpy(v) for k, v in data.items()}
    fa = _fed(n, "f32")
    sa, ma = fa.run_rounds(fa.init_paged_state(p, n_hot=n), batches, seq,
                           key=trandom.PRNGKey(16, device=CPU))
    fb = _fed(n, "f32", host_mesh)
    sb, mb = fb.run_rounds(fb.init_paged_state(p, n_hot=n, mesh=host_mesh), batches, seq,
                           key=trandom.PRNGKey(16, device=CPU))
    assert torch.equal(sa.theta_L.buf, sb.theta_L.buf)
    assert torch.equal(sa.bank.hot, sb.bank.hot)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_sharded_1x1_mesh_tree_parity(host_mesh):
    """The reference's tree case on a 1x1 mesh: nodes, counts and the
    ledger's tree view equal the unmeshed tree run bit for bit."""
    n, params, data, seq = _toy("N8-P28")
    got = run_case("N8-P28", "tree", "fused", host_mesh)
    want = run_case("N8-P28", "tree", "fused")
    np.testing.assert_array_equal(got["nodes"], want["nodes"])
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert got["reconciled"] == want["reconciled"]
    assert (got["counts"] <= 3).all() and got["counts"].sum() > 0


# --------------------------------------- col0 plain versions --------------------------------
SPLITS = ((0, 29, 64, 101), (0, 50, 101), (0, 101))


@pytest.mark.parametrize("cuts", SPLITS, ids=["three", "two", "one"])
def test_col0_slices_equal_the_full_row(cuts):
    from repro_torch.kernels.bank_codec.ops import (encode_row, row_absmax, row_scale,
                                                    scale_from_absmax)
    from repro_torch.kernels.dp_clip_noise.ops import dp_round_flat, dp_round_rows
    from repro_torch.kernels.tree_noise.ops import tree_delta_, tree_delta_rows_

    rng = np.random.default_rng(3)
    p, g = cuts[-1], 3
    tb = torch.from_numpy(rng.standard_normal((g, p)).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal((g, p)).astype(np.float32))
    keys = trandom.split(trandom.PRNGKey(7, device=CPU), g)
    gain, ns, w = (torch.full((g,), v, dtype=torch.float32) for v in (0.5, 0.3, 0.2))
    kw = dict(sigma=1e-2, lr_own=0.1, lr_l=0.05, n_owners=8, theta_max=2.0)
    full1 = dp_round_flat(tb[0], acc[0], keys[0], gain[:1], ns[:1], w[:1], **kw)
    fullg = dp_round_rows(tb, acc, keys, gain, ns, w, **kw)
    nodes = torch.from_numpy(rng.standard_normal((4, 3, p)).astype(np.float32))
    counts = torch.tensor([0, 1, 2, 6], dtype=torch.int32)
    owners = torch.tensor([1, 3, 0])
    tfull = nodes.clone()
    dfull = tree_delta_rows_(tfull, counts, owners, keys, ns)
    x = torch.from_numpy(rng.standard_normal(p).astype(np.float32))
    cfull, sfull, efull = encode_row(x, keys[0], "int8")
    assert torch.equal(trandom.bits_range(keys[0], 0, p), trandom.bits(keys[0], (p,)))
    parts = []
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        sl = slice(c0, c1)
        assert torch.equal(trandom.bits_range(keys, c0, c1), trandom.bits(keys, (p,))[:, sl])
        one = dp_round_flat(tb[0, sl], acc[0, sl], keys[0], gain[:1], ns[:1], w[:1],
                            col0=c0, **kw)
        rows = dp_round_rows(tb[:, sl].contiguous(), acc[:, sl].contiguous(), keys, gain, ns,
                             w, col0=c0, **kw)
        for a, b in zip(one, full1):
            assert torch.equal(a, b[sl])
        for a, b in zip(rows, fullg):
            assert torch.equal(a, b[:, sl])
        part = nodes[:, :, sl].clone()
        d = tree_delta_rows_(part, counts, owners, keys, ns, col0=c0)
        assert torch.equal(d, dfull[:, sl]) and torch.equal(part, tfull[:, :, sl])
        part1 = nodes[:, :, sl].clone()
        d1 = tree_delta_(part1, counts, owners[:1], keys[0], ns[:1], col0=c0)
        assert torch.equal(d1, dfull[0, sl])
        parts.append(row_absmax(x[sl]))
        codes, _, err = encode_row(x[sl], keys[0], "int8", col0=c0, scale=sfull)
        assert torch.equal(codes, cfull[sl]) and torch.equal(err, efull[sl])
    assert torch.equal(scale_from_absmax(torch.stack(parts), "int8"), sfull)
    assert torch.equal(scale_from_absmax(torch.stack(parts), "fp8"), row_scale(x, "fp8"))
    x[5] = float("nan")
    assert torch.isnan(scale_from_absmax(row_absmax(x[:50]), "int8")).all()
