"""A pytree state on the 1x1 mesh of a gloo world of one, bit for bit
against the unmeshed port, on the CPU: the K-round drivers.

The reduced yi-6b, f32, four owners, K = 4 rounds (tests/_pytree_mesh.py
says which owners, caps and fault codes): `make_fused_rounds` and
`make_group_rounds` under the paper mechanism, the tree at depth 2, the
fault layer and the fault layer with the staleness runtime, each with the
reference's `random.laplace` privatizer and (but for the tree, which needs
the flat engine to fuse) the fused `sqnorm` / `scale_noise` one. The
meshed state (theta_L, the bank and the nodes DTensors, each rank holding
its blocks) equals the unmeshed pytree twin's after the dispatch: theta_L,
every bank and node leaf, `step`, every ledger column, the leaf counts,
the fault and runtime columns and every metric. The train step, example
granularity, the other families and the sanitizer are in
tests/test_torch_pytree_mesh_families.py.

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_pytree_mesh.py
"""
import numpy as np
import pytest
import torch

from _pytree_mesh import Arch, assert_same, run_case
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.sharding import spmd
from repro_torch.tree_util import tree_flatten

CASES = [(form, fused) for form in ("plain", "tree", "faults", "stale")
         for fused in (False, True) if not (form == "tree" and fused)]


@pytest.fixture(scope="module")
def yi():
    torch.set_num_threads(1)
    return Arch("yi-6b")


def check_exercised(form, snap):
    """The case reached the layer it names: a refusal, faults, a timeout."""
    if form in ("plain", "tree"):
        assert snap["ledger.refused"].sum() == 1
    if form == "tree":
        assert snap["counts"].sum() == 3 and any(np.any(n != 0) for n in snap["nodes"])
    if form == "faults":
        assert snap["ledger.faulted"].sum() == 2 and snap["ledger.dropped"].sum() == 1
        assert snap["faults.quarantined"].sum() == 3      # a DROP is a fault event too
    if form == "stale":
        assert snap["ledger.timed_out"].sum() == 1 and snap["ledger.faulted"].sum() == 1
        assert snap["stale.clock"] == 4


@pytest.mark.parametrize("driver", ["fused", "group"])
@pytest.mark.parametrize("form,fused", CASES,
                         ids=[f"{f}-{'fused' if z else 'laplace'}" for f, z in CASES])
def test_one_by_one_mesh_is_bit_exact(yi, driver, form, fused):
    want, _ = run_case(yi, driver, form, fused, None)
    got, state = run_case(yi, driver, form, fused, make_debug_mesh(1, 1, device_type="cpu"))
    assert all(spmd.is_dtensor(x) for x in tree_flatten(state.theta_L)[0]
               + tree_flatten(state.bank)[0])
    if state.tree is not None:
        assert all(spmd.is_dtensor(x) for x in tree_flatten(state.tree.nodes)[0])
    check_exercised(form, want[-1])
    assert_same(got, want, exact=True)
