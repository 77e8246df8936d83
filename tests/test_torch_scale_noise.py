"""The port's scale_noise family and the pytree privatizer's tree entry
points (repro_torch.kernels.dp_clip_noise) against the reference's, on
the CPU.

The plain `scale_noise_ref` is held against the reference's jnp oracle and
its Pallas `scale_noise_2d` in interpret mode on the same uint32 bits; the
tree entry points (`fused_scale_noise_tree`, `fused_sqnorm_tree`,
`dp_privatize_tree`) draw from a key, one `split(key, n_leaves)` in jax's
leaf order, and are held against the reference's oracle route and its
interpret mode (block_rows 8). In jax's partitionable threefry the first n
words of bits(k, (R, 1024)) are bits(k, (n,)), so the padded interpret
draw and the unpadded oracle see the same noise as the port. Tolerances:
the element-wise ops are the same op sequence, so only log1p may differ by
an ulp: rtol 1e-6 and an absolute 2e-6 times the noise scale (one ulp of
the largest draw, |Laplace| <= 16.7, where the scaled gradient cancels
it); the squared norms sum in another order (rtol 1e-5), and so does the
clip factor built from them.
The CUDA kernel runs only on a card: tests/test_torch_cuda.py and
chip_smoke.py hold it against the plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federation import flatten as jflatten
from repro.federation import privacy as jprivacy
from repro.kernels.dp_clip_noise import kernel as jkernel
from repro.kernels.dp_clip_noise import ops as jops
from repro.kernels.dp_clip_noise import ref as jref
from repro_torch import random as trandom
from repro_torch.federation import flatten as tflatten
from repro_torch.federation import privacy as tprivacy
from repro_torch.kernels.dp_clip_noise import kernel as tkernel
from repro_torch.kernels.dp_clip_noise import ops as tops
from repro_torch.kernels.dp_clip_noise import ref as tref
from repro_torch.tree_util import tree_flatten

CPU = "cpu"
# leaves of several sizes: a (768,) vector as DENSE_124M's norms, a ragged
# 2-D leaf, a 0-d leaf, and one past two (8, 1024) blocks
SHAPES = {"a": (37,), "b": {"c": (3, 5), "d": ()}, "e": (768,), "f": (17000,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return (rng.standard_normal(node) * scale).astype(np.float32)

    return build(SHAPES)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(t_tree, j_tree, **tol):
    t_leaves, _ = tree_flatten(t_tree)
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def _noise_tol(ns):
    return dict(rtol=1e-6, atol=max(2e-6 * ns, 1e-7))


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("cs,ns", [(1.0, 0.0), (0.25, 1.3), (0.5, 4.0), (0.0, 0.7)])
def test_scale_noise_ref_matches_reference_ref(cs, ns):
    g, bits = _tree(0)["f"], _words(17000, 1)
    out = tref.scale_noise_ref(torch.from_numpy(g), torch.from_numpy(bits), cs, ns)
    ref = jref.scale_noise_ref(jnp.asarray(g), jnp.asarray(bits), cs, ns)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_noise_tol(ns))


def test_scale_noise_ref_matches_pallas_kernel_interpret():
    R = 16
    g = np.random.default_rng(2).standard_normal((R, jkernel.LANES)).astype(np.float32)
    bits = _words(R * jkernel.LANES, 3).reshape(R, jkernel.LANES)
    one = lambda v: jnp.full((1, 1), v, jnp.float32)   # noqa: E731
    ref = jkernel.scale_noise_2d(jnp.asarray(g), jnp.asarray(bits), one(0.375), one(0.9),
                                 block_rows=8, interpret=True)
    out = tref.scale_noise_ref(torch.from_numpy(g), torch.from_numpy(bits),
                               torch.tensor(0.375), torch.tensor(0.9))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_noise_tol(0.9))


@pytest.mark.parametrize("tensors", [False, True])
def test_fused_scale_noise_tree_matches_reference_oracle(tensors):
    tree = _tree(4)
    gain, ns = 0.5, 0.21
    t_gain, t_ns = (torch.tensor(gain), torch.tensor([ns])) if tensors else (gain, ns)
    out = tops.fused_scale_noise_tree(_torch(tree), trandom.PRNGKey(7, device=CPU),
                                      t_gain, t_ns)
    ref = jops.fused_scale_noise_tree(_jax(tree), jax.random.PRNGKey(7), gain, ns,
                                      interpret="oracle")
    _assert_trees_close(out, ref, **_noise_tol(ns))


def test_fused_scale_noise_tree_keys_follow_jax_leaf_order():
    # leaf i takes row i of split(key, n_leaves), the leaves in jax's order:
    # with a zero tree and unit noise each leaf is its key's Laplace draw
    zeros = jax.tree_util.tree_map(np.zeros_like, _tree(0))
    key = trandom.PRNGKey(9, device=CPU)
    out = tops.fused_scale_noise_tree(_torch(zeros), key, 1.0, 1.0)
    leaves, _ = tree_flatten(out)
    for leaf, k in zip(leaves, trandom.split(key, len(leaves))):
        want = tref.laplace_from_bits_ref(trandom.bits(k, leaf.shape))
        assert torch.equal(leaf, want)


def test_fused_sqnorm_tree_matches_reference():
    tree = _tree(5)
    out = tops.fused_sqnorm_tree(_torch(tree))
    assert out.shape == ()
    for interpret in ("oracle", True):
        ref = jops.fused_sqnorm_tree(_jax(tree), block_rows=8, interpret=interpret)
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


@pytest.mark.parametrize("xi,ns", [(1e6, 0.0), (0.5, 0.0), (0.5, 0.3), (1e6, 2.0)])
def test_dp_privatize_tree_matches_reference_interpret(xi, ns):
    # ns = 0: clip only (and xi = 1e6 no clip at all); ns > 0: with noise
    tree = _tree(6, scale=0.1)
    out = tops.dp_privatize_tree(_torch(tree), trandom.PRNGKey(3, device=CPU), xi, ns)
    ref = jops.dp_privatize_tree(_jax(tree), jax.random.PRNGKey(3), xi, ns,
                                 block_rows=8, interpret=True)
    _assert_trees_close(out, ref, rtol=1e-5, atol=_noise_tol(ns)["atol"])
    if ns == 0.0:
        norm = float(tops.fused_sqnorm_tree(out)) ** 0.5
        assert norm <= xi * (1 + 1e-6)


def test_dp_privatize_tree_clip_factor_on_the_device():
    # the clip factor never leaves the tensors: a tree of norm 4 clipped to 1
    tree = {"x": torch.full((4,), 2.0)}
    out = tops.dp_privatize_tree(tree, trandom.PRNGKey(0, device=CPU), 1.0, 0.0)
    assert torch.equal(out["x"], torch.full((4,), 0.5))


@pytest.mark.parametrize("scale", [0.0, 0.25, 3.0])
def test_laplace_noise_tree_matches_reference(scale):
    tree = _tree(8)
    out = tprivacy.laplace_noise_tree(trandom.PRNGKey(12, device=CPU), _torch(tree), scale)
    ref = jprivacy.laplace_noise_tree(jax.random.PRNGKey(12), _jax(tree), scale)
    # laplace within 1 ulp of jax.random.laplace, times the scale
    _assert_trees_close(out, ref, rtol=2.4e-7, atol=1e-30)


def test_pack_f32_and_unpack_f32_match_reference():
    tree = _tree(10)
    tspec, jspec = tflatten.flatten_spec(_torch(tree)), jflatten.flatten_spec(_jax(tree))
    buf = tspec.pack_f32(_torch(tree))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jspec.pack_f32(_jax(tree))))
    back = tspec.unpack_f32(buf)
    _assert_trees_close(back, jspec.unpack_f32(jnp.asarray(buf.numpy())), rtol=0, atol=0)
    assert all(leaf.data_ptr() >= buf.data_ptr() for leaf in tree_flatten(back)[0])
    with pytest.raises(ValueError):
        tspec.pack_f32({"a": torch.zeros(37)})


def test_dispatch_rule():
    # a CPU tensor runs the plain version (no launch is counted); a device
    # the port has no route for raises
    before = dict(tkernel.launches)
    g = torch.randn(300)
    key = trandom.PRNGKey(1, device=CPU)
    assert torch.equal(tops.scale_noise(g, key, 0.5, 0.1),
                       tref.scale_noise_ref(g, trandom.bits(key, (300,)), 0.5, 0.1))
    tops.dp_privatize_tree({"g": g}, key, 1.0, 0.1)
    assert tkernel.launches == before
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        tops.scale_noise(meta, key, 1.0, 1.0)
    with pytest.raises(ValueError, match="not supported"):
        tops.fused_sqnorm_tree({"g": meta})
    with pytest.raises(ValueError, match="needs CUDA"):
        tkernel.scale_noise_cuda(g, key, torch.ones(1), torch.ones(1))
