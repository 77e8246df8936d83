"""The port's checkpoints and crash-resume (`repro_torch.checkpoint`,
`Federation.save_session` / `restore_session`) on the CPU, and held against
the JAX reference's (`repro.checkpoint`).

Inside the port, as tests/test_checkpoint.py holds the reference: atomic
saves (`latest_step` never resumes from a temporary or a demoted shard,
overwriting a step leaves no residue), bf16 and fp8 round-trip bit for
bit, `extra` rides in the manifest, a missing leaf or a shape mismatch
fails loudly, aux arrays round-trip, every state (pytree, flat f32 and
bf16, int8 and fp8 banks, the tree) restores and CONTINUES a fault-armed
run_rounds bit for bit against the uninterrupted run, reconcile after a
restore is idempotent, a process that crashes after its checkpoint
resumes with the uninterrupted run's accounting, and the same for paged
sessions, whose cold tier rides in the shard.

Across the packages: the port keys every leaf as the reference's
`_flatten_with_paths` (key, dtype and shape) for flat, quantized, tree,
fault-armed and paged states; its msgpack codec writes `msgpack.packb`'s
bytes for a manifest and a journal and reads them back; a checkpoint
written by either package loads into the other bit for bit on every leaf
(bf16 and fp8 banks and a paged session's cold tier included), and the
port's `export_journal` equals the reference's after the same host
history.

As in the other port tests the model is a linear toy with microbatch
clipping (the fused flat engine takes microbatch granularity only).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import repro.federation as jfed
import repro_torch.federation as tfed
from repro.checkpoint import load_aux_arrays as j_load_aux
from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.checkpoint.store import _flatten_with_paths
from repro_torch import random as trandom
from repro_torch.checkpoint import (flatten_with_paths, latest_step, load_aux_arrays,
                                    load_checkpoint, load_manifest, save_checkpoint)
from repro_torch.checkpoint._msgpack import packb, unpackb
from repro_torch.checkpoint.store import to_storage
from repro_torch.convert import params_from_numpy

CPU = "cpu"
N, K = 3, 12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _fed(mod, *, pack=True, bank_dtype=None, fused=True, faults=True, staleness=False,
         mechanism="paper", tree_depth=None, horizon=16):
    kw = {}
    if faults:
        kw["fault_policy"] = mod.FaultPolicy(max_faults=4, window=8)
    if staleness:
        kw["staleness"] = mod.StalenessPolicy(deadline=1.0, max_retries=2, decay=0.9)
    if mod is tfed:
        kw["device"] = CPU
        if bank_dtype == "bfloat16":
            bank_dtype = torch.bfloat16
    elif bank_dtype == "bfloat16":
        bank_dtype = jnp.bfloat16
    fed = mod.Federation([mod.DataOwner(n=200, epsilon=2.0, xi=1.0)] * N,
                         mod.FederationConfig(horizon=horizon, sigma=1e-2, theta_max=10.0,
                                              lr_scale=5.0),
                         mechanism=mechanism, tree_depth=tree_depth, **kw)
    fed.make_step(_loss(mod), privatizer=mod.PrivatizerConfig(
        xi=1.0, granularity="microbatch", n_microbatches=2, fused_kernel=fused),
        pack_params=pack, bank_dtype=bank_dtype)
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


def _plan(mod, **rates):
    return mod.FaultPlan(**rates)


def _bits(x):
    """The raw bytes of a tensor or array (bf16/fp8 included)."""
    a = to_storage(x)[0] if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _leaves_equal(a, b):
    la, lb = flatten_with_paths(a), flatten_with_paths(b)
    assert list(la) == list(lb)
    return all(np.array_equal(_bits(la[k]), _bits(lb[k])) and la[k].dtype == lb[k].dtype
               for k in la)


SEQ = np.arange(K) % N


# ----------------------------------- the store ------------------------------------------
def test_roundtrip_plain_tree(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": {"c": torch.tensor(3, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 5, state)
    assert latest_step(str(tmp_path)) == 5
    back = load_checkpoint(str(tmp_path), 5, state)
    assert _leaves_equal(state, back)


def test_roundtrip_extended_dtypes(tmp_path):
    state = {"bf16": torch.arange(8, dtype=torch.float32).to(torch.bfloat16) / 3,
             "fp8": torch.tensor([1.5, -2.0, 0.125, 7.0]).to(torch.float8_e4m3fn)}
    save_checkpoint(str(tmp_path), 0, state)
    assert load_manifest(str(tmp_path), 0)["dtypes"] == {"bf16": "bfloat16",
                                                         "fp8": "float8_e4m3fn"}
    back = load_checkpoint(str(tmp_path), 0, state)
    for k in state:
        assert back[k].dtype == state[k].dtype
        assert np.array_equal(_bits(back[k]), _bits(state[k]))


def test_extra_rides_in_manifest(tmp_path):
    extra = {"journal": {"version": 1, "spent": [1, 2, 3]}}
    save_checkpoint(str(tmp_path), 2, {"x": torch.zeros(3)}, extra=extra)
    assert load_manifest(str(tmp_path), 2)["extra"] == extra
    save_checkpoint(str(tmp_path), 3, {"x": torch.zeros(3)})
    assert "extra" not in load_manifest(str(tmp_path), 3)


def test_latest_step_ignores_temp_trash_and_foreign(tmp_path):
    save_checkpoint(str(tmp_path), 4, {"x": torch.zeros(2)})
    os.makedirs(tmp_path / "_tmp_step_00000009.1234")
    os.makedirs(tmp_path / "_old_step_00000008.1234")
    os.makedirs(tmp_path / "step_garbage")
    (tmp_path / "README.txt").write_text("not a shard")
    assert latest_step(str(tmp_path)) == 4
    assert latest_step(str(tmp_path / "nope")) is None


def test_overwrite_existing_step_is_atomic(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(4)})
    save_checkpoint(str(tmp_path), 1, {"x": torch.ones(4)})
    back = load_checkpoint(str(tmp_path), 1, {"x": torch.zeros(4)})
    assert bool((back["x"] == 1.0).all())
    assert all(n.startswith("step_") for n in os.listdir(tmp_path))


def test_missing_leaf_and_shape_mismatch_fail_loudly(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"x": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(str(tmp_path), 0, {"x": torch.zeros(4), "y": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path), 0, {"x": torch.zeros(5)})


def test_aux_arrays_roundtrip(tmp_path):
    aux = {"cold/codes/ids": np.asarray([0, 2], np.int64),
           "cold/codes/rows": np.arange(14, dtype=np.int8).reshape(2, 7),
           "bf16": torch.arange(6, dtype=torch.float32).to(torch.bfloat16)}
    save_checkpoint(str(tmp_path), 3, {"x": torch.zeros(2)}, aux_arrays=aux)
    back = load_aux_arrays(str(tmp_path), 3)
    assert sorted(back) == sorted(aux)
    for k, v in aux.items():
        v = torch.as_tensor(v)
        assert back[k].dtype == v.dtype
        assert np.array_equal(_bits(back[k]), _bits(v))
    assert list(load_checkpoint(str(tmp_path), 3, {"x": torch.zeros(2)})) == ["x"]
    save_checkpoint(str(tmp_path), 4, {"x": torch.zeros(2)})
    assert load_aux_arrays(str(tmp_path), 4) == {}


# --------------------------------- the msgpack codec ---------------------------------------
def _journal_history(mod, params, data):
    """A mechanism after a fault-armed dispatch, a reconcile and a host-
    authorized round."""
    fed = _fed(mod, staleness=True, horizon=5)
    st = fed.init_state(_params(mod, params))
    lat = mod.LatencyPlan(base=(0.2, 2.0, 0.2), jitter=0.5)
    st, _ = fed.run_rounds(st, _batches(mod, data), SEQ if mod is tfed else jnp.asarray(SEQ),
                           key=_key(mod, 3), faults=_plan(mod, drop=0.2, stale=0.2),
                           latency=lat)
    fed.reconcile(st)
    fed.mechanism.authorize(1)
    return fed


def test_msgpack_codec_writes_and_reads_msgpack_bytes(toy):
    params, data = toy
    journal = _journal_history(jfed, params, data).mechanism.export_journal()
    manifest = {"step": 12, "keys": ["theta_L/0", "bank/0/0", "ledger/7"],
                "dtypes": {"theta_L/0": "float32", "bank/0/0": "bfloat16"},
                "shapes": {"theta_L/0": [7], "bank/0/0": [3, 70000]},
                "aux_keys": ["cold/rows/ids"], "extra": {"journal": journal,
                                                         "paging": {"n_hot": 2, "x": None}}}
    for obj in (manifest, journal, [-1, -33, -129, -2**31 - 1, 2**32, 1.5, True, "é" * 40],
                {"a" * 300: list(range(20))}):
        assert packb(obj) == msgpack.packb(obj)
        assert unpackb(msgpack.packb(obj)) == msgpack.unpackb(msgpack.packb(obj))
    # float32 values and bin payloads, which msgpack writes on request
    assert unpackb(msgpack.packb(0.25, use_single_float=True)) == 0.25
    assert unpackb(msgpack.packb(b"\x00\x01")) == b"\x00\x01"


def test_export_journal_equals_reference(toy):
    params, data = toy
    j = _journal_history(jfed, params, data).mechanism.export_journal()
    t = _journal_history(tfed, params, data).mechanism.export_journal()
    assert t == j and list(t) == list(j)
    assert packb(t) == msgpack.packb(j)


def test_restore_journal_reads_a_pre_staleness_journal(toy):
    params, data = toy
    fed = _journal_history(tfed, params, data)
    journal = fed.mechanism.export_journal()
    old = {k: v for k, v in journal.items()
           if k not in ("timed_out", "retried", "folded_timed_out", "folded_retried")}
    other = _fed(tfed, staleness=True, horizon=5)
    other.mechanism.restore_journal(old)
    got = other.mechanism.export_journal()
    assert got["responses"] == journal["responses"]
    assert got["timed_out"] == [0] * N and got["folded_retried"] == [0] * N
    with pytest.raises(ValueError, match="version"):
        other.mechanism.restore_journal(dict(journal, version=2))
    with pytest.raises(ValueError, match="owners"):
        other.mechanism.restore_journal(dict(journal, refusals=[0]))


# ------------------------------ leaf keys across packages -----------------------------------
# (make_step kwargs, Federation kwargs, paged n_hot or None)
KEY_STATES = {
    "flat-f32": (dict(), dict(faults=False), None),
    "flat-bf16": (dict(bank_dtype="bfloat16"), dict(faults=False), None),
    "int8": (dict(bank_dtype="int8"), dict(faults=False), None),
    "fp8": (dict(bank_dtype="fp8"), dict(faults=False), None),
    "tree-flat": (dict(), dict(faults=False, mechanism="tree", tree_depth=2), None),
    "tree-pytree": (dict(pack=False, fused=False),
                    dict(faults=False, mechanism="tree", tree_depth=2), None),
    "pytree-faults-staleness": (dict(pack=False), dict(staleness=True), None),
    "paged-int8-faults-staleness": (dict(bank_dtype="int8"), dict(staleness=True), 2),
    "paged-f32": (dict(), dict(faults=False), 2),
    "paged-tree": (dict(), dict(faults=False, mechanism="tree", tree_depth=2), 2),
}


def _state_of(mod, name, params):
    step_kw, fed_kw, n_hot = KEY_STATES[name]
    fed = _fed(mod, **step_kw, **fed_kw)
    p = _params(mod, params)
    st = fed.init_state(p) if n_hot is None else fed.init_paged_state(p, n_hot=n_hot)
    return fed, st


@pytest.mark.parametrize("name", list(KEY_STATES))
def test_leaf_keys_dtypes_and_shapes_equal_reference(toy, name):
    params, _ = toy
    _, js = _state_of(jfed, name, params)
    _, ts = _state_of(tfed, name, params)
    want = {k: (str(v.dtype), v.shape) for k, v in _flatten_with_paths(js).items()}
    got = {}
    for k, v in flatten_with_paths(ts).items():
        arr, logical = to_storage(v)
        got[k] = (logical, arr.shape)
    assert list(got) == list(want)
    assert got == want


# ------------------------- checkpoints that cross the packages ------------------------------
CROSS = ("flat-f32", "flat-bf16", "fp8", "tree-pytree", "pytree-faults-staleness",
         "paged-int8-faults-staleness")


def _trained(mod, name, params, data):
    fed, st = _state_of(mod, name, params)
    seq = np.array([0, 1, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0]) if KEY_STATES[name][2] else SEQ
    kw = {}
    if fed.fault_policy is not None:
        kw["faults"] = _plan(mod, drop=0.2, stale=0.1, nonfinite=0.1, corrupt=0.1)
    st, _ = fed.run_rounds(st, _batches(mod, data), seq if mod is tfed else jnp.asarray(seq),
                           key=_key(mod, 9), **kw)
    fed.reconcile(st)
    return fed, st


def _assert_leaves_bit_equal(tleaves, jleaves):
    assert list(tleaves) == list(jleaves)
    for k in jleaves:
        np.testing.assert_array_equal(_bits(tleaves[k]), _bits(jleaves[k]), err_msg=k)


@pytest.mark.parametrize("name", CROSS)
def test_reference_checkpoint_loads_into_the_port(toy, tmp_path, name):
    params, data = toy
    jf, js = _trained(jfed, name, params, data)
    jf.save_session(str(tmp_path), js)
    tf, like = _state_of(tfed, name, params)
    ts = tf.restore_session(str(tmp_path), like)
    _assert_leaves_bit_equal(flatten_with_paths(ts), _flatten_with_paths(js))
    assert ts.ledger.sid == js.ledger.sid
    assert tf.mechanism.export_journal() == jf.mechanism.export_journal()
    if tf.pager is not None:
        for store_name, store in jf.pager.stores.items():
            mine = tf.pager.stores[store_name]
            np.testing.assert_array_equal(mine.written_ids, store.written_ids)
            np.testing.assert_array_equal(_bits(mine.read_rows(mine.written_ids)),
                                          _bits(store.read_rows(store.written_ids)))
            np.testing.assert_array_equal(tf.pager.resident_ids, jf.pager.resident_ids)


@pytest.mark.parametrize("name", CROSS)
def test_port_checkpoint_loads_into_the_reference(toy, tmp_path, name):
    params, data = toy
    tf, ts = _trained(tfed, name, params, data)
    tf.save_session(str(tmp_path), ts)
    jf, like = _state_of(jfed, name, params)
    js = jf.restore_session(str(tmp_path), like)
    _assert_leaves_bit_equal(flatten_with_paths(ts), _flatten_with_paths(js))
    assert js.ledger.sid == ts.ledger.sid
    assert jf.mechanism.export_journal() == tf.mechanism.export_journal()
    if jf.pager is not None:
        aux = j_load_aux(str(tmp_path), int(ts.step))
        for store_name, store in tf.pager.stores.items():
            ids = store.written_ids
            np.testing.assert_array_equal(aux[f"cold/{store_name}/ids"], ids)
            np.testing.assert_array_equal(_bits(jf.pager.stores[store_name].read_rows(ids)),
                                          _bits(store.read_rows(ids)))


def test_store_level_checkpoints_cross_with_extended_dtypes(tmp_path):
    rng = np.random.default_rng(5)
    bits16 = rng.integers(0, 1 << 16, 9).astype(np.uint16)
    bits8 = rng.integers(0, 256, 9).astype(np.uint8)
    tstate = {"bf16": torch.from_numpy(bits16).view(torch.bfloat16),
              "fp8": torch.from_numpy(bits8).view(torch.float8_e4m3fn),
              "i": torch.arange(4, dtype=torch.int32)}
    jstate = {"bf16": jnp.asarray(bits16).view(jnp.bfloat16),
              "fp8": jnp.asarray(bits8).view(jnp.float8_e4m3fn),
              "i": jnp.arange(4, dtype=jnp.int32)}
    save_checkpoint(str(tmp_path / "t"), 1, tstate, aux_arrays={"rows": tstate["bf16"]})
    back = j_load_checkpoint(str(tmp_path / "t"), 1, jstate)
    for k in tstate:
        np.testing.assert_array_equal(_bits(back[k]), _bits(tstate[k]))
    np.testing.assert_array_equal(_bits(j_load_aux(str(tmp_path / "t"), 1)["rows"]),
                                  bits16.view(np.uint8))
    j_save_checkpoint(str(tmp_path / "j"), 2, jstate, aux_arrays={"rows": jstate["fp8"]})
    back = load_checkpoint(str(tmp_path / "j"), 2, tstate)
    for k in tstate:
        assert back[k].dtype == tstate[k].dtype
        np.testing.assert_array_equal(_bits(back[k]), _bits(jstate[k]))
    aux = load_aux_arrays(str(tmp_path / "j"), 2)
    assert aux["rows"].dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bits(aux["rows"]), bits8)


# ------------------------------ session resume, every state -----------------------------------
# (make_step kwargs, Federation kwargs)
VARIANTS = {
    "pytree": (dict(pack=False), {}),
    "flat-f32": ({}, {}),
    "flat-bf16": (dict(bank_dtype="bfloat16"), {}),
    "int8": (dict(bank_dtype="int8"), {}),
    "fp8": (dict(bank_dtype="fp8"), {}),
    "tree": (dict(pack=False, fused=False), dict(mechanism="tree", tree_depth=3)),
}
PLAN = dict(drop=0.2, stale=0.1, nonfinite=0.1, corrupt=0.1)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_restored_state_continues_bit_for_bit(toy, tmp_path, name):
    params, data = toy
    step_kw, fed_kw = VARIANTS[name]
    cut = K // 2
    first, rest = slice(0, cut), slice(cut, K)

    def run(fed, st, sl, seed):
        return fed.run_rounds(st, _batches(tfed, data, sl), SEQ[sl], key=_key(tfed, seed),
                              faults=_plan(tfed, **PLAN))[0]

    fed_a = _fed(tfed, **step_kw, **fed_kw)
    s_a = run(fed_a, fed_a.init_state(_params(tfed, params)), first, 31)
    s_a = run(fed_a, s_a, rest, 32)
    led_a = fed_a.reconcile(s_a)

    fed_b = _fed(tfed, **step_kw, **fed_kw)
    s_b = run(fed_b, fed_b.init_state(_params(tfed, params)), first, 31)
    fed_b.reconcile(s_b)
    step = fed_b.save_session(str(tmp_path), s_b)
    assert latest_step(str(tmp_path)) == step

    fed_c = _fed(tfed, **step_kw, **fed_kw)
    s_c = fed_c.restore_session(str(tmp_path), fed_c.init_state(_params(tfed, params)))
    assert _leaves_equal(s_b, s_c)
    s_c = run(fed_c, s_c, rest, 32)
    assert _leaves_equal(s_a, s_c)
    assert int(s_a.step) == int(s_c.step)
    assert fed_c.reconcile(s_c) == led_a


def test_restore_without_checkpoint_raises(toy, tmp_path):
    params, _ = toy
    fed = _fed(tfed, bank_dtype="int8")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        fed.restore_session(str(tmp_path / "empty"), fed.init_state(_params(tfed, params)))


def test_reconcile_after_restore_is_idempotent(toy, tmp_path):
    params, data = toy
    fed = _fed(tfed, bank_dtype="int8")
    s = fed.init_state(_params(tfed, params))
    s, _ = fed.run_rounds(s, _batches(tfed, data), SEQ, key=_key(tfed, 41),
                          faults=_plan(tfed, drop=0.3))
    led = fed.reconcile(s)
    fed.save_session(str(tmp_path), s)
    fed2 = _fed(tfed, bank_dtype="int8")
    s2 = fed2.restore_session(str(tmp_path), fed2.init_state(_params(tfed, params)))
    assert fed2.reconcile(s2) == led
    assert fed2.reconcile(s2) == led


# --------------------------------- a real crash ------------------------------------------------
_CHILD = textwrap.dedent("""
    import os, sys
    import numpy as np, torch
    import repro_torch.federation as tfed
    from repro_torch import random as trandom
    from repro_torch.convert import params_from_numpy

    ckpt, paged = sys.argv[1], sys.argv[2] == "paged"
    N, K = 3, 12
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal(6).astype(np.float32), "b": np.zeros((), np.float32)}
    data = {"x": rng.standard_normal((K, 4, 6)).astype(np.float32),
            "y": np.ones((K, 4), np.float32)}
    loss = lambda p, b: torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
    kw = {}
    if paged:
        kw["staleness"] = tfed.StalenessPolicy(deadline=1.0, max_retries=2, decay=0.9)
    fed = tfed.Federation([tfed.DataOwner(n=200, epsilon=2.0, xi=1.0)] * N,
                          tfed.FederationConfig(horizon=16, sigma=1e-2, theta_max=10.0,
                                                lr_scale=5.0),
                          fault_policy=tfed.FaultPolicy(max_faults=4, window=8), device="cpu",
                          **kw)
    fed.make_step(loss, privatizer=tfed.PrivatizerConfig(
        xi=1.0, granularity="microbatch", n_microbatches=2, fused_kernel=True),
        pack_params=True, bank_dtype="int8")
    p = params_from_numpy(params, device="cpu")
    s = fed.init_paged_state(p, n_hot=2) if paged else fed.init_state(p)
    plan = tfed.FaultPlan(drop=0.2, stale=0.2)
    lat = tfed.LatencyPlan(base=(0.2, 2.0, 0.2), jitter=0.5) if paged else None
    for c, seq in enumerate(CHUNKS):
        if c == 2:
            fed.reconcile(s)
            fed.save_session(ckpt, s)
        sl = slice(3 * c, 3 * c + 3)
        s, _ = fed.run_rounds(s, {k: torch.from_numpy(v[sl].copy()) for k, v in data.items()},
                              np.asarray(seq), key=trandom.PRNGKey(60 + c, device="cpu"),
                              faults=plan, latency=lat)
    # trained past the checkpoint; die without saving
    os._exit(1)
""")
# each chunk touches at most 2 owners, so an n_hot = 2 hot tier pages
CHUNKS = ([0, 1, 0], [1, 2, 2], [0, 0, 1], [2, 1, 2])


def _resume_after_crash(tmp_path, toy, paged):
    params, data = toy
    ckpt = str(tmp_path / "ckpt")
    child = tmp_path / "child.py"
    child.write_text(f"CHUNKS = {CHUNKS!r}\n" + _CHILD)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run([sys.executable, str(child), ckpt, "paged" if paged else "flat"],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 1, proc.stderr          # the crash, not a fault
    assert latest_step(ckpt) is not None

    def make():
        fed = _fed(tfed, bank_dtype="int8", staleness=paged)
        p = _params(tfed, params)
        return fed, (fed.init_paged_state(p, n_hot=2) if paged else fed.init_state(p))

    plan = _plan(tfed, drop=0.2, stale=0.2)
    lat = tfed.LatencyPlan(base=(0.2, 2.0, 0.2), jitter=0.5) if paged else None

    def run(fed, st, chunks):
        for c in chunks:
            sl = slice(3 * c, 3 * c + 3)
            st, _ = fed.run_rounds(st, _batches(tfed, data, sl), np.asarray(CHUNKS[c]),
                                   key=_key(tfed, 60 + c), faults=plan, latency=lat)
        return st

    fed_a, s_a = make()
    s_a = run(fed_a, s_a, range(4))
    led_a = fed_a.reconcile(s_a)
    fed_b, like = make()
    s_b = run(fed_b, fed_b.restore_session(ckpt, like), range(2, 4))
    for part in ("theta_L", "bank", "faults", "stale", "ledger"):
        assert _leaves_equal(getattr(s_a, part), getattr(s_b, part)), part
    assert int(s_a.step) == int(s_b.step)
    # epsilon recovered exactly: nothing charged twice, nothing lost
    assert fed_b.reconcile(s_b) == led_a
    return fed_a, s_a, fed_b, s_b


def test_crash_resume_matches_uninterrupted_run(toy, tmp_path):
    _resume_after_crash(tmp_path, toy, paged=False)


def test_paged_crash_resume_matches_uninterrupted_run(toy, tmp_path):
    fed_a, s_a, fed_b, s_b = _resume_after_crash(tmp_path, toy, paged=True)
    assert fed_b.pager.stats["evictions"] > 0
    snap_a, snap_b = fed_a.pager.snapshot(s_a), fed_b.pager.snapshot(s_b)
    for name in snap_a:
        np.testing.assert_array_equal(snap_a[name], snap_b[name])


# ------------------------------- paged sessions ------------------------------------------------
def test_paged_restored_state_continues_bit_for_bit(toy, tmp_path):
    params, data = toy
    plan = _plan(tfed, **PLAN)

    def run(fed, st, chunks, seed=None):
        for c in chunks:
            sl = slice(3 * c, 3 * c + 3)
            st, _ = fed.run_rounds(st, _batches(tfed, data, sl), np.asarray(CHUNKS[c]),
                                   key=_key(tfed, 60 + c if seed is None else seed),
                                   faults=plan)
        return st

    def make():
        fed = _fed(tfed, bank_dtype="int8")
        return fed, fed.init_paged_state(_params(tfed, params), n_hot=2)

    fed_a, s_a = make()
    s_a = run(fed_a, s_a, range(4))
    led_a = fed_a.reconcile(s_a)
    fed_b, s_b = make()
    s_b = run(fed_b, s_b, range(2))
    fed_b.reconcile(s_b)
    step = fed_b.save_session(str(tmp_path), s_b)
    assert latest_step(str(tmp_path)) == step

    fed_c, like = make()
    s_c = fed_c.restore_session(str(tmp_path), like)
    assert _leaves_equal(s_b, s_c)
    s_c = run(fed_c, s_c, range(2, 4))
    assert _leaves_equal(s_a.theta_L, s_c.theta_L) and _leaves_equal(s_a.faults, s_c.faults)
    assert int(s_a.step) == int(s_c.step)
    assert fed_c.reconcile(s_c) == led_a
    fed_a.pager.flush(s_a, only_dirty=False)
    fed_c.pager.flush(s_c, only_dirty=False)
    for name, store in fed_a.pager.stores.items():
        other = fed_c.pager.stores[name]
        np.testing.assert_array_equal(store.written_ids, other.written_ids)
        np.testing.assert_array_equal(store.read_rows(store.written_ids),
                                      other.read_rows(other.written_ids))

    # restoring into a session that trained past the save wipes its newer
    # cold rows and rewinds
    s_b = run(fed_b, s_b, range(2, 4), seed=99)
    s_b2 = run(fed_b, fed_b.restore_session(str(tmp_path), s_b), range(2, 4))
    assert _leaves_equal(s_a.theta_L, s_b2.theta_L)
    assert fed_b.reconcile(s_b2) == led_a


def test_paged_restore_error_paths(toy, tmp_path):
    params, data = toy
    p = _params(tfed, params)
    fed = _fed(tfed, bank_dtype="int8")
    s = fed.init_paged_state(p, n_hot=N)
    s, _ = fed.run_rounds(s, _batches(tfed, data), SEQ, key=_key(tfed, 31))
    fed.save_session(str(tmp_path / "paged"), s)

    flat = _fed(tfed, bank_dtype="int8")
    with pytest.raises(ValueError, match="init_paged_state"):
        flat.restore_session(str(tmp_path / "paged"), flat.init_state(p))

    flat2 = _fed(tfed, bank_dtype="int8")
    s2 = flat2.init_state(p)
    s2, _ = flat2.run_rounds(s2, _batches(tfed, data), SEQ, key=_key(tfed, 31))
    flat2.save_session(str(tmp_path / "flat"), s2)
    paged = _fed(tfed, bank_dtype="int8")
    with pytest.raises(ValueError, match="no cold-tier snapshot"):
        paged.restore_session(str(tmp_path / "flat"), paged.init_paged_state(p, n_hot=N))

    other = _fed(tfed, bank_dtype="fp8")
    with pytest.raises(ValueError, match="stores"):
        other.restore_session(str(tmp_path / "paged"), other.init_paged_state(p, n_hot=N))


# ------------------------------------ the Mechanism protocol ---------------------------------
def test_mechanism_protocol_is_exported_and_satisfied():
    from repro_torch.federation import Mechanism
    from repro_torch.federation.mechanisms import Mechanism as FromModule
    assert Mechanism is FromModule
    owners = [tfed.DataOwner(n=200, epsilon=2.0, xi=1.0)] * N
    cfg = tfed.FederationConfig(horizon=16)
    for spec in ("paper", "strict", "per_owner_rounds", "tree"):
        mech = tfed.make_mechanism(spec, owners, cfg, tree_depth=4 if spec == "tree" else None)
        assert isinstance(mech, Mechanism), spec
    assert not isinstance(object(), Mechanism)
    # the same members as the reference's protocol
    members = {m for m in dir(jfed.Mechanism) if not m.startswith("_")}
    assert members <= {m for m in dir(Mechanism) if not m.startswith("_")}
