"""The reduced qwen3-moe-30b-a3b (moe_mode "onehot") as a pytree state on
the 1x1 mesh of a gloo world of one, bit for bit against the unmeshed port, on the CPU: the rest
of the grid that tests/test_torch_pytree_mesh_families.py starts.

With the cases of tests/_pytree_mesh.py (four owners): `make_train_step`
(two host-authorized rounds), `make_fused_rounds` and `make_group_rounds`
(K = 4), each under the paper mechanism, the tree at depth 2, the fault
layer and the fault layer with the staleness runtime, with the reference's
`random.laplace` privatizer and (but for the tree) the fused one. The two
cases the families file runs (the fused driver under the tree, the grouped
driver under faults + staleness with the fused privatizer) are not
repeated. The meshed state equals the unmeshed twin's after each call
(theta_L, the bank, the nodes, `step`, the ledger, the leaf counts, the
fault and runtime columns, every metric).

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_pytree_mesh_moe.py
"""
import pytest
import torch

from _pytree_mesh import GRID, Arch, grid_ids, run_grid_case


@pytest.fixture(scope="module")
def arch():
    torch.set_num_threads(1)
    return Arch("qwen3-moe-30b-a3b")


@pytest.mark.parametrize("driver,form,fused", GRID, ids=grid_ids(GRID))
def test_qwen3_moe_on_the_one_by_one_mesh_is_bit_exact(arch, driver, form, fused):
    run_grid_case(arch, driver, form, fused)
