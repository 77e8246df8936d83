"""Shared cases of the pytree-state-on-a-mesh tests (not collected: no
`test_` prefix).

A case is (driver, form, privatizer) on a reduced arch: the driver one of
make_train_step ("train", one round a call), make_fused_rounds ("fused")
and make_group_rounds ("group"); the form "plain" (the paper mechanism),
"tree" (the DP-FTRL tree at depth 2), "faults" (a FaultPolicy) or "stale"
(a FaultPolicy and a StalenessPolicy with decay); the privatizer the
reference's `random.laplace` draw ("laplace") or the fused `sqnorm` /
`scale_noise` pass ("fused"), at microbatch granularity (two pre-grouped
microbatches) or per example ("example"). Four owners, K = 4 rounds over
owners 1, 0, 2, 1: owner 1's second round is refused under the caps of
"plain" and "tree", the grouped driver runs a group of three and one of
one, and the fault codes of "faults" and "stale" hold every code but one
each (OK, NONFINITE_GRAD, DROP, STALE; OK, TIMEOUT, CORRUPT_PAYLOAD, OK),
with one fault quarantining an owner.

`run_case` returns a snapshot of the whole state after each dispatch (the
train step: after each round) as numpy: theta_L, the bank, `step`, every
ledger column, the tree's nodes and counts, the fault and runtime columns
and every metric.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs import get_config
from repro_torch.federation import faults as F
from repro_torch.federation import schedules
from repro_torch.federation.deep import (init_state, make_fused_rounds, make_group_rounds,
                                         make_train_step)
from repro_torch.federation.faults import FaultPolicy
from repro_torch.federation.staleness import StalenessPolicy
from repro_torch.launch.steps import default_async_cfg
from repro_torch.models import build_model
from repro_torch.sharding import rules, spmd
from repro_torch.tree_util import tree_flatten

CPU = "cpu"
K = 4
N_OWNERS = 4
OWNERS = np.array([1, 0, 2, 1])
CAPS = {"plain": (3, 1, 3, 3), "tree": (3, 1, 3, 3), "faults": None, "stale": None}
CODES = {"faults": [F.OK, F.NONFINITE_GRAD, F.DROP, F.STALE],
         "stale": [F.OK, F.TIMEOUT, F.CORRUPT_PAYLOAD, F.OK]}
MODEL_KW = {"qwen3-moe-30b-a3b": {"moe_mode": "onehot"}}
LEDGER = ("spent", "cap", "refused", "dropped", "faulted", "quarantined", "timed_out",
          "retried")
TRAIN_ROUNDS = 2
SEQ = 16


def async_cfg(form: str, fused: bool, example: bool = False):
    a = default_async_cfg(n_owners=N_OWNERS, n_microbatches=2)
    priv = dataclasses.replace(a.privatizer, fused_kernel=fused)
    if example:
        priv = dataclasses.replace(priv, granularity="example", pre_grouped=False)
    kw = {}
    if form == "tree":
        kw["tree_depth"] = 2
    if form in ("faults", "stale"):
        kw["fault_policy"] = FaultPolicy(max_faults=1, window=4)
    if form == "stale":
        kw["staleness"] = StalenessPolicy(deadline=1.0, max_retries=1, decay=0.9)
    return dataclasses.replace(a, privatizer=priv, caps=CAPS[form], **kw)


class Arch:
    """A reduced arch's model, seeded params, batches and keys."""

    def __init__(self, arch: str, example: bool = False):
        self.cfg = get_config(arch).reduced()
        self.model = build_model(self.cfg, remat=False, **MODEL_KW.get(arch, {}))
        self.params = self.model.init(seed=0, device=CPU)
        rng = np.random.default_rng(5)
        shape = (K, 3, SEQ) if example else (K, 2, 1, SEQ)
        toks = rng.integers(0, self.cfg.vocab, size=shape, dtype=np.int32)
        self.np_batches = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1)}
        self.batches = {k: torch.from_numpy(v) for k, v in self.np_batches.items()}
        self.keys = random.split(random.PRNGKey(7, device=CPU), K)

    def loss_fn(self, p, b):
        return self.model.loss(p, b)[0]

    def state(self, acfg, mesh):
        specs = None if mesh is None else rules.param_specs(self.params, self.cfg, mesh)
        return init_state(self.params, acfg, device=CPU, mesh=mesh, specs=specs)


def full(t):
    """A copy as numpy (the state is updated in place by the next call)."""
    return (t.full_tensor() if spmd.is_dtensor(t) else t).detach().numpy().copy()


def snapshot(state, metrics):
    out = {"theta": [full(x) for x in tree_flatten(state.theta_L)[0]],
           "bank": [full(x) for x in tree_flatten(state.bank)[0]],
           "step": full(state.step)}
    for name in LEDGER:
        col = getattr(state.ledger, name, None)
        if col is not None:
            out["ledger." + name] = full(col)
    if state.tree is not None:
        out["nodes"] = [full(x) for x in tree_flatten(state.tree.nodes)[0]]
        out["counts"] = full(state.tree.counts)
    for part in ("faults", "stale"):
        sub = getattr(state, part)
        if sub is not None:
            for name, col in sub._asdict().items():
                out[f"{part}.{name}"] = full(col)
    for name, v in metrics.items():
        out["metric." + name] = full(v)
    return out


def fault_codes(form):
    return torch.tensor(CODES[form], dtype=torch.int8) if form in CODES else None


def run_case(arch: Arch, driver: str, form: str, fused: bool, mesh, example: bool = False,
             state=None, k: int = K):
    """(snapshots, the final state) of one case; `state` (default: a fresh
    one) is consumed."""
    acfg = async_cfg(form, fused, example)
    state = arch.state(acfg, mesh) if state is None else state
    codes = fault_codes(form)
    owners = torch.from_numpy(OWNERS[:k])
    b = {n: v[:k] for n, v in arch.batches.items()}
    outs = []
    if driver == "train":
        step = make_train_step(arch.loss_fn, acfg, device=CPU)
        for r in range(min(k, TRAIN_ROUNDS)):
            state, m = step(state, {n: v[r] for n, v in b.items()}, owners[r:r + 1],
                            arch.keys[r], None if codes is None else int(codes[r]))
            outs.append(snapshot(state, m))
    elif driver == "fused":
        run = make_fused_rounds(arch.loss_fn, acfg, device=CPU)
        state, m = run(state, b, owners, arch.keys[:k], None if codes is None else codes[:k])
        outs.append(snapshot(state, m))
    else:
        run = make_group_rounds(arch.loss_fn, acfg, device=CPU)
        gi, gv = schedules.pack_groups(schedules.partition_conflict_free(OWNERS[:k]))
        state, m = run(state, b, owners, arch.keys[:k], gi, gv,
                       None if codes is None else codes[:k])
        outs.append(snapshot(state, m))
    return outs, state


def assert_same(got, want, exact: bool, rtol=1e-4, atol=1e-6, skip=()):
    """Every entry of two snapshot lists equal (bit for bit, NaN where NaN)
    or, with exact False, the floats to rtol/atol and the rest exact; the
    entries named in `skip` are the caller's to check."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            if name in skip:
                continue
            gs, ws = (g[name], w[name]) if isinstance(w[name], list) else ([g[name]], [w[name]])
            assert len(gs) == len(ws), name
            for a, b in zip(gs, ws):
                assert a.shape == b.shape and a.dtype == b.dtype, name
                if exact or not np.issubdtype(b.dtype, np.floating):
                    np.testing.assert_array_equal(a, b, err_msg=name)
                else:
                    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


# the 1x1 grid of zamba2 and qwen3-moe beyond the two cases of
# tests/test_torch_pytree_mesh_families.py (which stay there)
FAMILY_CASES = (("fused", "tree", False), ("group", "stale", True))
GRID = [(driver, form, fused) for driver in ("train", "fused", "group")
        for form in ("plain", "tree", "faults", "stale") for fused in (False, True)
        if not (form == "tree" and fused) and (driver, form, fused) not in FAMILY_CASES]


def grid_ids(cases):
    return [f"{d}-{f}-{'fused' if z else 'laplace'}" for d, f, z in cases]


def run_grid_case(arch: Arch, driver: str, form: str, fused: bool):
    """One case on the 1x1 gloo mesh against its unmeshed twin, bit for bit."""
    from repro_torch.launch.mesh import make_debug_mesh
    want, _ = run_case(arch, driver, form, fused, None)
    got, _ = run_case(arch, driver, form, fused, make_debug_mesh(1, 1, device_type="cpu"))
    assert len(want) == (TRAIN_ROUNDS if driver == "train" else 1)
    assert_same(got, want, exact=True)
