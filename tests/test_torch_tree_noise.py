"""The port's tree_noise family (the DP-FTRL node refresh) held against the
JAX reference on the CPU.

The reference runs as its own tests run it off the TPU: the jnp oracle
(`ref.tree_delta_ref`, and `ops.tree_delta_row(..., interpret="oracle")`).
The port runs its plain versions on CPU tensors. The masks are integer
logic and match exactly. The fresh draw goes through the Laplace inverse
CDF, whose log1p may differ by an ulp between the packages, so the fresh
level agrees to rtol 1e-6, and delta = draw - retired sum to 1e-6 of the
terms it was computed from (|draw| + |retired sum|: the subtraction can
cancel, so an ulp of the draw is more than an ulp of delta). The state
that is only copied is exact: retired levels are 0.0 and untouched
levels keep their bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tree_noise.ops import tree_delta_row as jax_tree_delta_row
from repro.kernels.tree_noise.ref import tree_delta_ref as jax_tree_delta_ref
from repro.kernels.tree_noise.ref import tree_masks_ref as jax_tree_masks_ref
from repro_torch import random as trandom
from repro_torch.kernels.tree_noise import kernel, ops, ref

CPU = "cpu"
RTOL = 1e-6


def _bits(rng, p):
    return rng.integers(0, 1 << 32, size=p, dtype=np.uint64).astype(np.uint32)


def _t_bits(bits):
    return torch.from_numpy(bits.astype(np.int64)).to(torch.uint32)


def _assert_delta_close(got, want, nodes, count):
    """|got - want| <= RTOL * (|draw| + |retired sum|), the draw bounded by
    |want| + |retired sum|."""
    depth = nodes.shape[0]
    retired = ref.tree_masks_ref(count, depth)[0].numpy() if depth else np.zeros(0, bool)
    rsum = np.abs(nodes[retired]).sum(axis=0) if retired.any() else 0.0
    bound = RTOL * (np.abs(want) + 2.0 * rsum)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_masks_equal_reference_for_every_count(depth):
    for count in range((1 << depth) + 1):
        j_ret, j_fresh = jax_tree_masks_ref(jnp.int32(count), depth)
        t_ret, t_fresh = ref.tree_masks_ref(count, depth)
        np.testing.assert_array_equal(t_ret.numpy(), np.asarray(j_ret))
        np.testing.assert_array_equal(t_fresh.numpy(), np.asarray(j_fresh))
        # a count tensor gives the same masks
        t_ret2, _ = ref.tree_masks_ref(torch.tensor([count], dtype=torch.int32), depth)
        assert torch.equal(t_ret2, t_ret)


@pytest.mark.parametrize("depth,p", [(1, 257), (3, 1000), (4, 4099)])
def test_plain_tree_delta_matches_reference_oracle(depth, p):
    rng = np.random.default_rng(depth)
    nodes = rng.standard_normal((depth, p)).astype(np.float32)
    bits = _bits(rng, p)
    ns = np.float32(0.37)
    for count in range((1 << depth) - 1):
        j_delta, j_nodes = jax_tree_delta_ref(jnp.asarray(nodes), jnp.asarray(bits),
                                              jnp.int32(count), jnp.asarray(ns))
        t_delta, t_nodes = ref.tree_delta_ref(torch.from_numpy(nodes), _t_bits(bits), count,
                                              torch.tensor([ns]))
        _assert_delta_close(t_delta.numpy(), np.asarray(j_delta), nodes, count)
        retired, fresh = (m.numpy() for m in ref.tree_masks_ref(count, depth))
        for lvl in range(depth):
            got = t_nodes[lvl].numpy()
            if retired[lvl]:
                np.testing.assert_array_equal(got, np.zeros(p, np.float32))
            elif fresh[lvl]:
                np.testing.assert_allclose(got, np.asarray(j_nodes[lvl]), rtol=RTOL, atol=0)
            else:
                np.testing.assert_array_equal(got, nodes[lvl])          # untouched
        assert fresh.sum() == 1 and retired.sum() == bin(count + 1 ^ count).count("1") - 1


def test_tree_delta_row_from_a_key_matches_reference_oracle():
    rng = np.random.default_rng(7)
    nodes = rng.standard_normal((3, 2051)).astype(np.float32)
    for count in (0, 1, 3, 6):
        j_delta, j_nodes = jax_tree_delta_row(jnp.asarray(nodes), count, jax.random.PRNGKey(3),
                                              0.5, interpret="oracle")
        t_delta, t_nodes = ops.tree_delta_row(torch.from_numpy(nodes), count,
                                              trandom.PRNGKey(3, device=CPU), 0.5)
        _assert_delta_close(t_delta.numpy(), np.asarray(j_delta), nodes, count)
        np.testing.assert_allclose(t_nodes.numpy(), np.asarray(j_nodes), rtol=RTOL, atol=0)
    # depth 0: fresh noise, no node traffic
    j_delta, _ = jax_tree_delta_row(jnp.zeros((0, 100)), 5, jax.random.PRNGKey(4), 2.0,
                                    interpret="oracle")
    t_delta, t_nodes = ops.tree_delta_row(torch.zeros(0, 100), 5, trandom.PRNGKey(4, device=CPU),
                                          2.0)
    assert t_nodes.shape == (0, 100)
    np.testing.assert_allclose(t_delta.numpy(), np.asarray(j_delta), rtol=RTOL, atol=0)


@pytest.mark.parametrize("count", [0, 1, 2, 3, 6])
def test_in_place_form_updates_one_owner_masked_by_the_grant(count):
    gen = torch.Generator().manual_seed(count)
    nodes = torch.randn(3, 3, 515, generator=gen)
    counts = torch.tensor([4, count, 1], dtype=torch.int32)
    owner = torch.tensor([1])
    key = trandom.PRNGKey(11, device=CPU)
    ns = torch.tensor([0.25])
    want_delta, want_row = ops.tree_delta_row(nodes[1], count, key, ns)

    granted = nodes.clone()
    delta = ops.tree_delta_(granted, counts, owner, key, ns, torch.ones((), dtype=torch.int32))
    assert torch.equal(delta, want_delta)
    assert torch.equal(granted[1], want_row)
    assert torch.equal(granted[0], nodes[0]) and torch.equal(granted[2], nodes[2])
    assert torch.equal(counts, torch.tensor([4, count, 1], dtype=torch.int32))  # not bumped

    refused = nodes.clone()
    delta0 = ops.tree_delta_(refused, counts, owner, key, ns, torch.zeros((), dtype=torch.int32))
    assert torch.equal(refused, nodes)                  # bit-exact: no node changes
    assert torch.equal(delta0, want_delta)              # delta is still written

    again = nodes.clone()
    assert torch.equal(ops.tree_delta_(again, counts, owner, key, ns), want_delta)
    assert torch.equal(again, granted)                  # no grant given = granted


@pytest.mark.parametrize("depth,t,p", [(1, 1, 1), (3, 7, 2), (4, 15, 3), (5, 31, 1)])
def test_cumulative_noise_telescopes_to_the_active_nodes(depth, t, p):
    # after each leaf the summed deltas equal the sum of the active nodes:
    # popcount(t) of them, the O(log K) property of the mechanism
    nodes = torch.zeros(depth, p)
    cum = np.zeros(p, np.float64)
    for leaf in range(t):
        delta, nodes = ops.tree_delta_row(nodes, leaf, trandom.PRNGKey(leaf, device=CPU), 1.0)
        cum += delta.numpy().astype(np.float64)
        active = [lvl for lvl in range(depth) if bool(nodes[lvl].ne(0).any())]
        assert len(active) == bin(leaf + 1).count("1") <= depth
        assert active == [lvl for lvl in range(depth) if (leaf + 1) >> lvl & 1]
        np.testing.assert_allclose(cum, nodes.numpy().astype(np.float64).sum(axis=0),
                                   rtol=1e-5, atol=1e-5)


def test_dispatch_follows_the_tensor():
    nodes = torch.zeros(1, 2, 8, device="meta")
    counts = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        ops.tree_delta_(nodes, counts, torch.zeros(1, dtype=torch.int64, device="meta"),
                        torch.zeros(2, dtype=torch.uint32, device="meta"),
                        torch.ones(1, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.tree_delta_cuda(torch.zeros(1, 2, 8), torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int64),
                               trandom.PRNGKey(0, device=CPU), torch.ones(1))
    before = dict(kernel.launches)
    ops.tree_delta_row(torch.zeros(2, 8), 0, trandom.PRNGKey(0, device=CPU), 1.0)
    assert kernel.launches == before                   # the CPU never counts a launch
