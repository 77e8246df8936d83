"""Noise drawn block by block, on the CPU.

A leaf of a model on a device mesh is split into blocks, one per rank.
The reference draws each leaf's noise inside `jit`, where jax's
partitionable threefry hashes counter i for element i of the leaf
whatever the sharding, so a meshed round draws the unmeshed noise. The
port draws each rank's block alone and must give the same:

  * `random.bits_block` (and the block draws of `uniform`, `laplace`,
    `normal`) equal the matching slice of the whole leaf's draw, for 1-,
    2-, 3- and 4-D leaves cut on one and on two dims, with stacked dims in
    front and blocks of one element;
  * `ops._block_layout` (the kernel's (A, R, C) view of a block) maps
    every element of a block to its flat index in the leaf;
  * the block `scale_noise` plain version (`scale_noise_ref` fed by
    `bits_block`, what `ops.scale_noise(..., block=)` runs on CPU tensors)
    equals the slice of the whole-leaf pass, bit for bit;
  * on DTensor leaves of a 1x1 gloo mesh, `privacy.laplace_noise_tree`,
    `fused_scale_noise_tree` and `fused_sqnorm_tree` equal the plain
    tree's, bit for bit.

The card's counterpart (the block kernel tiling the whole launch) is in
tests/test_torch_cuda.py and chip_smoke.py's phase kernels.

Run alone: PYTHONPATH=src python -m pytest -q tests/test_torch_block_noise.py
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch import random
from repro_torch.kernels.dp_clip_noise import ops
from repro_torch.kernels.dp_clip_noise.ref import scale_noise_ref

CPU = "cpu"

# (leaf shape, how many pieces each dim is cut into)
CUTS = [((10,), (2,)), ((12,), (3,)),
        ((8, 12), (2, 1)), ((8, 12), (1, 4)), ((8, 12), (2, 2)),
        ((3, 8, 12), (1, 2, 1)), ((3, 8, 12), (1, 1, 4)), ((3, 8, 12), (1, 2, 2)),
        ((2, 4, 6, 8), (1, 2, 1, 2)), ((2, 4, 6, 8), (1, 1, 3, 4)), ((2, 4, 6, 8), (1, 4, 1, 1)),
        ((4, 5, 6), (1, 5, 2))]


def _blocks(shape, cuts):
    """Every (offsets, local_shape) of a leaf cut evenly `cuts` ways."""
    sizes = [d // c for d, c in zip(shape, cuts)]
    for idx in itertools.product(*(range(c) for c in cuts)):
        yield tuple(i * s for i, s in zip(idx, sizes)), tuple(sizes)


def _slice(offsets, local):
    return tuple(slice(o, o + n) for o, n in zip(offsets, local))


@pytest.mark.parametrize("shape,cuts", CUTS, ids=lambda v: "x".join(map(str, v)))
def test_bits_block_is_the_slice_of_the_whole_draw(shape, cuts):
    key = random.PRNGKey(11, device=CPU)
    whole = {"bits": random.bits(key, shape), "uniform": random.uniform(key, shape),
             "laplace": random.laplace(key, shape), "normal": random.normal(key, shape)}
    for offsets, local in _blocks(shape, cuts):
        sl = _slice(offsets, local)
        assert torch.equal(random.bits_block(key, shape, offsets, local), whole["bits"][sl])
        for name in ("uniform", "laplace", "normal"):
            got = getattr(random, name)(key, shape, block=(offsets, local))
            assert torch.equal(got, whole[name][sl]), name


def test_bits_block_takes_a_batch_of_keys_and_checks_its_block():
    keys = random.split(random.PRNGKey(3, device=CPU), 3)
    whole = random.bits(keys, (6, 8))
    assert torch.equal(random.bits_block(keys, (6, 8), (2, 4), (2, 4)), whole[:, 2:4, 4:8])
    assert torch.equal(random.bits_range(keys[0], 5, 9),
                       random.bits_block(keys[0], (12,), (5,), (4,)))
    with pytest.raises(ValueError, match="leaves the leaf"):
        random.bits_block(keys[0], (6, 8), (4, 4), (4, 4))
    with pytest.raises(ValueError, match="does not match"):
        random.bits_block(keys[0], (6, 8), (0,), (6,))


@pytest.mark.parametrize("shape,cuts", CUTS, ids=lambda v: "x".join(map(str, v)))
def test_block_layout_maps_every_element_to_its_index(shape, cuts):
    flat = torch.arange(int(np.prod(shape))).reshape(shape)
    for offsets, local in _blocks(shape, cuts):
        base, R, C, SR, SA = ops._block_layout(shape, offsets, local)
        i = torch.arange(int(np.prod(local)))
        c, t = i % C, i // C
        got = base + (t // R) * SA + (t % R) * SR + c
        assert torch.equal(got, flat[_slice(offsets, local)].reshape(-1))


def test_block_layout_of_a_whole_leaf_is_one_range():
    assert ops._block_layout((8, 12), (0, 0), (8, 12)) == (0, 1, 96, 0, 0)
    # whole rows: one range starting at the block's first element
    assert ops._block_layout((3, 8, 12), (1, 0, 0), (1, 8, 12))[:3] == (96, 1, 96)
    assert ops._block_layout((), (), ()) == (0, 1, 1, 1, 1)
    with pytest.raises(NotImplementedError, match="more than two dims"):
        ops._block_layout((4, 4, 4, 4), (0, 2, 0, 2), (2, 2, 2, 2))


@pytest.mark.parametrize("shape,cuts", CUTS, ids=lambda v: "x".join(map(str, v)))
def test_block_scale_noise_tiles_the_whole_pass(shape, cuts):
    key = random.PRNGKey(5, device=CPU)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    cs, ns = torch.tensor([0.75]), torch.tensor([0.125])
    whole = ops.scale_noise(g, key, cs, ns)
    assert torch.equal(whole, scale_noise_ref(g, random.bits(key, shape), 0.75, 0.125))
    out = torch.empty_like(g)
    for offsets, local in _blocks(shape, cuts):
        sl = _slice(offsets, local)
        block = ops.scale_noise(g[sl].contiguous(), key, cs, ns, (shape, offsets))
        assert torch.equal(block, scale_noise_ref(
            g[sl], random.bits_block(key, shape, offsets, local), 0.75, 0.125))
        out[sl] = block
    assert torch.equal(out, whole)


@pytest.fixture(scope="module")
def one_by_one():
    from repro_torch.launch.mesh import make_debug_mesh
    return make_debug_mesh(1, 1, device_type="cpu")


def test_tree_draws_on_dtensor_leaves_equal_the_plain_tree(one_by_one):
    from repro_torch.configs import get_config
    from repro_torch.federation.privacy import laplace_noise_tree
    from repro_torch.models import build_model
    from repro_torch.sharding import rules, spmd
    from repro_torch.tree_util import tree_flatten
    cfg = get_config("zamba2-2.7b").reduced()
    params = build_model(cfg).init(seed=1, device=CPU)
    meshed = rules.distribute(params, rules.param_specs(params, cfg, one_by_one), one_by_one)
    key = random.PRNGKey(9, device=CPU)
    scale = torch.tensor(0.5)

    def full(tree):
        return [x.full_tensor() if spmd.is_dtensor(x) else x for x in tree_flatten(tree)[0]]

    for fn in (lambda t: laplace_noise_tree(key, t, scale),
               lambda t: ops.fused_scale_noise_tree(t, key, 0.25, scale)):
        a, b = full(fn(params)), full(fn(meshed))
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    total = ops.fused_sqnorm_tree(meshed)
    assert spmd.is_dtensor(total) and torch.equal(total.full_tensor(),
                                                  ops.fused_sqnorm_tree(params))
