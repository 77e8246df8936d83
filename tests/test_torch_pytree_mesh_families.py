"""A pytree state on the 1x1 mesh of a gloo world of one against the
unmeshed port, on the CPU: the train step's grid, the other families,
example granularity and the key-reuse sanitizer.

With the cases of tests/_pytree_mesh.py (four owners; the paper
mechanism, the tree at depth 2, the fault layer, the fault layer with the
staleness runtime; the reference's `random.laplace` privatizer and the
fused one):

  (a) `make_train_step` (two host-authorized rounds) on the reduced yi-6b
      over the whole grid, and `make_fused_rounds` under the tree and
      `make_group_rounds` under faults + staleness (fused privatizer) on
      the reduced zamba2-2.7b and qwen3-moe-30b-a3b (moe_mode "onehot";
      the rest of their grid is in tests/test_torch_pytree_mesh_zamba2.py
      and tests/test_torch_pytree_mesh_moe.py): the meshed state equals the unmeshed twin's BIT FOR BIT after each
      call (theta_L, the bank, the nodes, `step`, the ledger, the leaf
      counts, the fault and runtime columns, every metric);
  (b) example granularity (three examples a round) on the reduced yi-6b:
      torch.func.vmap does not pass through the meshed model, so each
      example's gradient is a backward pass of a batch of one there
      (`dp_sgd._example_grads_meshed`), and the meshed state agrees with
      the unmeshed one (vmap's gradients) to rtol 1e-4 plus 1e-5 of each
      array's largest magnitude, PR 25's bound for example granularity;
      the integer state and clip_frac exactly;
  (c) `dpcheck.sanitize()` over a meshed fused dispatch with the tree and
      over one under faults and staleness: no key is drawn twice, every
      draw is read (`skipped` 0), each leaf's noise a block draw of the
      leaf's whole (1x1) block.

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_pytree_mesh_families.py
"""
import numpy as np
import pytest
import torch

from _pytree_mesh import Arch, assert_same, full, run_case
from repro_torch.analysis.dpcheck import sanitize
from repro_torch.launch.mesh import make_debug_mesh

FORMS = [(form, fused) for form in ("plain", "tree", "faults", "stale")
         for fused in (False, True) if not (form == "tree" and fused)]


def _mesh():
    return make_debug_mesh(1, 1, device_type="cpu")


@pytest.fixture(scope="module")
def yi():
    torch.set_num_threads(1)
    return Arch("yi-6b")


@pytest.mark.parametrize("form,fused", FORMS,
                         ids=[f"{f}-{'fused' if z else 'laplace'}" for f, z in FORMS])
def test_train_step_on_the_one_by_one_mesh_is_bit_exact(yi, form, fused):
    want, _ = run_case(yi, "train", form, fused, None)
    got, _ = run_case(yi, "train", form, fused, _mesh())
    assert len(want) == 2
    assert_same(got, want, exact=True)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("driver,form,fused", [("fused", "tree", False),
                                               ("group", "stale", True)],
                         ids=["fused-tree-laplace", "group-stale-fused"])
def test_other_families_on_the_one_by_one_mesh_are_bit_exact(arch, driver, form, fused):
    torch.set_num_threads(1)
    a = Arch(arch)
    want, _ = run_case(a, driver, form, fused, None)
    got, _ = run_case(a, driver, form, fused, _mesh())
    assert_same(got, want, exact=True)


@pytest.fixture(scope="module")
def yi_examples():
    torch.set_num_threads(1)
    return Arch("yi-6b", example=True)


def _assert_example_bound(got, want):
    """PR 25's bound: rtol 1e-4 plus 1e-5 of the array's largest magnitude
    on the floats; the integer state and clip_frac exact."""
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            gs, ws = (g[name], w[name]) if isinstance(w[name], list) else ([g[name]], [w[name]])
            for a, b in zip(gs, ws):
                if np.issubdtype(b.dtype, np.floating) and name != "metric.clip_frac":
                    big = float(np.nanmax(np.abs(b))) if b.size else 0.0
                    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * big, err_msg=name)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=name)


EXAMPLE_CASES = [("train", "plain", False), ("train", "plain", True),
                 ("fused", "plain", True), ("group", "tree", False)]


@pytest.mark.parametrize("driver,form,fused", EXAMPLE_CASES,
                         ids=[f"{d}-{f}-{'fused' if z else 'laplace'}"
                              for d, f, z in EXAMPLE_CASES])
def test_example_granularity_on_the_one_by_one_mesh(yi_examples, driver, form, fused):
    want, _ = run_case(yi_examples, driver, form, fused, None, example=True)
    got, _ = run_case(yi_examples, driver, form, fused, _mesh(), example=True)
    _assert_example_bound(got, want)


@pytest.mark.parametrize("form,fused", [("tree", False), ("stale", True)],
                         ids=["tree-laplace", "faults-stale-fused"])
def test_sanitizer_over_a_meshed_dispatch(yi, form, fused):
    from repro_torch.federation.deep import init_state
    from _pytree_mesh import async_cfg
    from repro_torch.sharding import rules
    mesh = _mesh()
    state = init_state(yi.params, async_cfg(form, fused), device="cpu", mesh=mesh,
                       specs=rules.param_specs(yi.params, yi.cfg, mesh))
    with sanitize() as rec:
        out, state = run_case(yi, "fused", form, fused, mesh, state=state)
    assert rec.skipped == 0 and rec.draws > 0
    # one draw per leaf a granted or refused round (the round's kernels and
    # draws run whatever its outcome), all of them block draws
    n_leaves = len(out[-1]["theta"])
    assert rec.draws == 4 * n_leaves, (rec.draws, rec.by_what)
    assert int(full(state.step)) == int(out[-1]["step"])
