"""A pytree state on a mesh against the reference's own meshed drivers, on
the CPU.

The reference's `make_fused_rounds`, `make_group_rounds` and
`make_train_step`, jitted with `in_shardings` on its `make_debug_mesh(1,
1)` as its launcher places a state (theta_L by `rules.param_specs`, the
bank by `param_specs(..., bank_axis=True)`, the ledger, the noise trees and
the fault and runtime columns replicated), against the port's drivers on
the 1x1 mesh of a gloo world of one (`deep.init_state(..., mesh=,
specs=)`), on the reduced yi-6b with the converted weights
(`convert.params_from_numpy`) and the same batches, owners, keys and fault
codes (tests/_pytree_mesh.py's cases):

  (a) the fused driver under the tree at depth 2 (the `random.laplace`
      privatizer), the grouped driver under faults + staleness (the fused
      privatizer) and two train-step rounds under faults;
  (b) a mid-run reference state (the tree at depth 3, fault-armed, after
      one dispatch of the reference's fused driver) carried onto the mesh
      by `convert.pytree_state_from_numpy(..., mesh=, specs=)` with
      `tree_noise_from_numpy(..., mesh=, specs=)`, each rank building only
      its blocks, then one more dispatch in both packages.

theta_L, the bank and the nodes agree to rtol 1e-4 and atol 1e-6 (the
bound of tests/test_torch_train_mesh_reference.py); `step`, the ledger,
the leaf counts, the fault and runtime columns and the owner, refusal and
fault metrics exactly. A checksum sums its row's bits, so it equals the
reference's where the two rows are bit-equal, and the port's stored
checksums equal `bank_checksums` of its own bank.

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_pytree_mesh_reference.py
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from _pytree_mesh import CODES, OWNERS, Arch, async_cfg, full, run_case
from repro.configs import get_config as jget_config
from repro.federation import deep as jdeep
from repro.federation import schedules as jschedules
from repro.federation.faults import FaultPolicy as JFaultPolicy
from repro.federation.staleness import StalenessPolicy as JStalenessPolicy
from repro.launch.mesh import make_debug_mesh as jmesh
from repro.launch.steps import default_async_cfg as jdefault_async_cfg
from repro.models import build_model as jbuild_model
from repro.sharding import rules as jrules
from repro_torch.convert import (device_ledger_from_numpy, fault_state_from_numpy,
                                 params_from_numpy, pytree_state_from_numpy,
                                 tree_noise_from_numpy)
from repro_torch.federation import faults as tfaults
from repro_torch.federation.deep import make_fused_rounds
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.sharding import rules
from repro_torch.tree_util import tree_flatten

RTOL, ATOL = 1e-4, 1e-6
K = 4
LEDGER = ("spent", "cap", "refused", "dropped", "faulted", "quarantined", "timed_out",
          "retried")
INT_METRICS = ("owner", "refused", "faulted", "dropped", "quarantined", "timed_out",
               "retried", "clip_frac")


def _jcfg_of(acfg):
    """The reference's AsyncDPConfig of a port one (the cases' fields)."""
    a = jdefault_async_cfg(n_owners=acfg.n_owners, n_microbatches=2)
    p = acfg.privatizer
    priv = dataclasses.replace(a.privatizer, fused_kernel=p.fused_kernel,
                               granularity=p.granularity, pre_grouped=p.pre_grouped)
    fp, sp = acfg.fault_policy, acfg.staleness
    return dataclasses.replace(
        a, privatizer=priv, caps=acfg.caps, tree_depth=acfg.tree_depth,
        fault_policy=None if fp is None else JFaultPolicy(fp.max_faults, fp.window),
        staleness=None if sp is None else JStalenessPolicy(sp.deadline, sp.max_retries,
                                                           sp.backoff_cap, sp.decay))


class Ref:
    """The reference's reduced yi-6b, its weights and its 1x1 mesh."""

    def __init__(self):
        self.cfg = jget_config("yi-6b").reduced()
        self.lm = jbuild_model(self.cfg, remat=False)
        self.params = self.lm.init(jax.random.PRNGKey(4), jnp.float32)
        self.mesh = jmesh(1, 1)

    def loss(self, p, b):
        return self.lm.loss(p, b)[0]

    def shardings(self, state):
        """The launcher's placement of a pytree state: theta_L and the bank
        by the rules, the rest replicated (a pytree prefix)."""
        rep = NamedSharding(self.mesh, JP())

        def sh(specs):
            return jax.tree_util.tree_map(lambda s: NamedSharding(self.mesh, s), specs,
                                          is_leaf=lambda x: isinstance(x, JP))
        return type(state)(
            theta_L=sh(jrules.param_specs(state.theta_L, self.cfg, self.mesh)),
            bank=sh(jrules.param_specs(state.bank, self.cfg, self.mesh, bank_axis=True)),
            step=rep, ledger=rep, tree=None if state.tree is None else rep,
            faults=None if state.faults is None else rep,
            stale=None if state.stale is None else rep)

    def driver(self, driver: str, jacfg, state):
        """The reference's driver jitted with in_shardings on its mesh:
        f(state, batches, owners, keys, codes, *groups)."""
        rep = NamedSharding(self.mesh, JP())
        if driver == "fused":
            run = jdeep.make_fused_rounds(self.loss, jacfg)

            def f(s, b, o, k, c):
                return run(s, b, o, k, fault_codes=c)
            n_rest = 4
        elif driver == "group":
            run = jdeep.make_group_rounds(self.loss, jacfg)

            def f(s, b, o, k, c, gi, gv):
                return run(s, b, o, k, gi, gv, fault_codes=c)
            n_rest = 6
        else:
            run = jdeep.make_train_step(self.loss, jacfg)

            def f(s, b, o, k, c):
                return run(s, b, o, k, fault_code=c)
            n_rest = 4
        return jax.jit(f, in_shardings=(self.shardings(state),) + (rep,) * n_rest)


@pytest.fixture(scope="module")
def ref():
    return Ref()


@pytest.fixture(scope="module")
def port(ref):
    torch.set_num_threads(1)
    arch = Arch("yi-6b")
    arch.params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref.params),
                                    device="cpu")
    return arch


def _run_reference(ref, port, driver, form, acfg, state=None, codes=None, f=None):
    """The reference's (state, metrics) after one dispatch (the train step:
    two rounds) of `driver` from `state` (default: a fresh one), with the
    form's fault codes unless `codes` are given; `f` a jitted driver to
    reuse."""
    jacfg = _jcfg_of(acfg)
    state = jdeep.init_state(ref.params, jacfg) if state is None else state
    b = {k: jnp.asarray(v) for k, v in port.np_batches.items()}
    keys = jnp.asarray(port.keys.numpy())
    codes = CODES.get(form) if codes is None else codes
    codes = None if codes is None else jnp.asarray(np.asarray(codes, np.int8))
    with ref.mesh:
        f = ref.driver(driver, jacfg, state) if f is None else f
        if driver == "train":
            m = None
            for r in range(2):
                state, m = f(state, {k: v[r] for k, v in b.items()}, jnp.int32(OWNERS[r]),
                             keys[r], None if codes is None else codes[r])
            return state, m
        args = (state, b, jnp.asarray(OWNERS, jnp.int32), keys, codes)
        if driver == "group":
            gi, gv = jschedules.pack_groups(jschedules.partition_conflict_free(OWNERS))
            return f(*args, jnp.asarray(gi), jnp.asarray(gv))
        return f(*args)


def _compare(tstate, jstate, tmetrics=None, jmetrics=None):
    def close(t_tree, j_tree):
        ts, js = tree_flatten(t_tree)[0], jax.tree_util.tree_leaves(j_tree)
        assert len(ts) == len(js) > 0
        for t, j in zip(ts, js):
            np.testing.assert_allclose(full(t), np.asarray(j), rtol=RTOL, atol=ATOL)

    close(tstate.theta_L, jstate.theta_L)
    close(tstate.bank, jstate.bank)
    assert int(full(tstate.step)) == int(jstate.step)
    for name in LEDGER:
        np.testing.assert_array_equal(full(getattr(tstate.ledger, name)),
                                      np.asarray(getattr(jstate.ledger, name)), err_msg=name)
    assert (tstate.tree is None) == (jstate.tree is None)
    if tstate.tree is not None:
        close(tstate.tree.nodes, jstate.tree.nodes)
        np.testing.assert_array_equal(full(tstate.tree.counts), np.asarray(jstate.tree.counts))
    assert (tstate.faults is None) == (jstate.faults is None)
    if tstate.faults is not None:
        for name in ("win_faults", "contacts", "quarantined"):
            np.testing.assert_array_equal(full(getattr(tstate.faults, name)),
                                          np.asarray(getattr(jstate.faults, name)),
                                          err_msg=name)
        stored = full(tstate.faults.checksum)
        np.testing.assert_array_equal(stored, tfaults.bank_checksums(tstate.bank).numpy())
        same = np.ones(stored.shape, bool)
        for t, j in zip(tree_flatten(tstate.bank)[0], jax.tree_util.tree_leaves(jstate.bank)):
            t, j = full(t), np.asarray(j)
            same &= (t.reshape(len(same), -1) == j.reshape(len(same), -1)).all(axis=1)
        np.testing.assert_array_equal(stored[same], np.asarray(jstate.faults.checksum)[same])
    assert (tstate.stale is None) == (jstate.stale is None)
    if tstate.stale is not None:
        for name in jstate.stale._fields:
            np.testing.assert_array_equal(full(getattr(tstate.stale, name)),
                                          np.asarray(getattr(jstate.stale, name)),
                                          err_msg=name)
    if tmetrics is not None:
        for name in INT_METRICS:
            if name in tmetrics and name in jmetrics:
                np.testing.assert_array_equal(full(tmetrics[name]), np.asarray(jmetrics[name]),
                                              err_msg=name)


CASES = [("fused", "tree", False), ("group", "stale", True), ("train", "faults", False)]


@pytest.mark.parametrize("driver,form,fused", CASES,
                         ids=[f"{d}-{f}-{'fused' if z else 'laplace'}" for d, f, z in CASES])
def test_meshed_drivers_agree_with_the_reference_meshed_drivers(ref, port, driver, form, fused):
    acfg = async_cfg(form, fused)
    js, jm = _run_reference(ref, port, driver, form, acfg)
    mesh = make_debug_mesh(1, 1, device_type="cpu")
    outs, ts = run_case(port, driver, form, fused, mesh)
    # the grouped reference's metrics are group-major; the state is the contract
    tm = None if driver == "group" else {k[len("metric."):]: torch.from_numpy(v)
                                         for k, v in outs[-1].items()
                                         if k.startswith("metric.")}
    _compare(ts, js, tm, None if driver == "group" else jm)


def test_mid_run_reference_state_runs_on_on_the_mesh(ref, port):
    # the tree at depth 3 (capacity 7), a fault policy that quarantines at
    # the third fault: the first dispatch (a corrupt payload) leaves counts
    # 1, 2, 0, 0 and active nodes; the second (a non-finite update) runs on
    # from there in both packages
    form = "faults"
    acfg = dataclasses.replace(async_cfg(form, False), tree_depth=3, caps=(7,) * 4,
                               fault_policy=tfaults.FaultPolicy(max_faults=3, window=8))
    first, second = [0, 0, 4, 0], [0, 3, 0, 0]
    jacfg = _jcfg_of(acfg)
    with ref.mesh:
        f = ref.driver("fused", jacfg, jdeep.init_state(ref.params, jacfg))
    js, _ = _run_reference(ref, port, "fused", form, acfg, codes=first, f=f)
    np.testing.assert_array_equal(np.asarray(js.tree.counts), [1, 2, 0, 0])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    mesh = make_debug_mesh(1, 1, device_type="cpu")
    specs = rules.param_specs(port.params, port.cfg, mesh)
    led = js.ledger
    ts = pytree_state_from_numpy(
        np_tree(js.theta_L), np_tree(js.bank), int(js.step),
        tree=tree_noise_from_numpy(np_tree(js.tree.nodes), np.asarray(js.tree.counts), 3,
                                   device="cpu", mesh=mesh, specs=specs),
        ledger=device_ledger_from_numpy(*(np.asarray(getattr(led, n)) for n in LEDGER),
                                        device="cpu"),
        faults=fault_state_from_numpy(*map(np.asarray, js.faults), device="cpu"),
        device="cpu", mesh=mesh, specs=specs)
    for leaf, nodes in zip(tree_flatten(ts.theta_L)[0], tree_flatten(ts.tree.nodes)[0]):
        assert tuple(nodes.to_local().shape) == (4, 3) + tuple(leaf.to_local().shape)
    np.testing.assert_array_equal(full(ts.faults.checksum),
                                  tfaults.bank_checksums(ts.bank).numpy())
    js, jm = _run_reference(ref, port, "fused", form, acfg, state=js, codes=second, f=f)
    run = make_fused_rounds(port.loss_fn, acfg, device="cpu")
    ts, tm = run(ts, port.batches, torch.from_numpy(OWNERS), port.keys,
                 torch.tensor(second, dtype=torch.int8))
    np.testing.assert_array_equal(np.asarray(js.tree.counts), [1, 4, 1, 0])
    _compare(ts, js, tm, jm)
