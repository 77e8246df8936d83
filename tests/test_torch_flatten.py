"""The port's flat representation against repro.federation.flatten.

Leaf order decides the layout of every bank row, and a wrong order fails
nowhere loudly, so offsets, shapes and the packed buffers must be equal
exactly: jax flattens dicts in sorted-key order, NamedTuples in field
order, and drops None fields.
"""
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.federation import flatten as jflatten
from repro.models import build_model as jax_build_model
from repro_torch.configs.base import DENSE_124M
from repro_torch.convert import params_from_numpy
from repro_torch.federation import flatten as tflatten
from repro_torch.models import LM

CPU = "cpu"
JAX_REDUCED = JaxModelConfig(
    name="dense-124m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab=50304).reduced()


@pytest.fixture(scope="module")
def lm_params():
    jparams = jax_build_model(JAX_REDUCED, remat=False).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)


def test_reduced_lm_spec_equals_reference(lm_params):
    jparams, tparams = lm_params
    jspec, tspec = jflatten.flatten_spec(jparams), tflatten.flatten_spec(tparams)
    assert tspec.shapes == jspec.shapes
    assert tspec.offsets == jspec.offsets
    assert tspec.size == jspec.size == DENSE_124M.reduced().param_count()


def test_reduced_lm_packed_buffer_is_bit_equal(lm_params):
    jparams, tparams = lm_params
    ref = np.asarray(jflatten.pack_params(jparams).buf)
    np.testing.assert_array_equal(tflatten.pack_params(tparams, device=CPU).buf.numpy(), ref)


def test_leaf_order_is_jax_order(lm_params):
    _, tparams = lm_params
    leaves, _ = tflatten.tree_flatten(tparams)
    blocks = tparams["blocks"]
    expected = [blocks["attn"].wq, blocks["attn"].wk, blocks["attn"].wv, blocks["attn"].wo,
                blocks["ffn"].w_gate, blocks["ffn"].w_up, blocks["ffn"].w_down,
                blocks["ln1"], blocks["ln2"], tparams["embed"], tparams["ln_f"],
                tparams["unembed"]]
    assert len(leaves) == len(expected)
    assert all(a is b for a, b in zip(leaves, expected))


def test_port_init_has_the_reference_structure():
    tparams = LM(DENSE_124M.reduced()).init(seed=0, device=CPU)
    jparams = jax_build_model(JAX_REDUCED, remat=False).init(jax.random.PRNGKey(0))
    jspec, tspec = jflatten.flatten_spec(jparams), tflatten.flatten_spec(tparams)
    assert (tspec.shapes, tspec.offsets) == (jspec.shapes, jspec.offsets)


class _NT(NamedTuple):
    a: torch.Tensor
    skip: Optional[torch.Tensor]
    c: torch.Tensor


class _JNT(NamedTuple):
    a: jax.Array
    skip: Optional[jax.Array]
    c: jax.Array


def test_mixed_tree_order_scalars_and_none():
    rng = np.random.default_rng(0)
    arrs = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("z", (2, 3)), ("a", ()), ("m", (4,)), ("c", (1, 2)))}
    jtree = {"z": jnp.asarray(arrs["z"]), "b": [jnp.asarray(arrs["a"])],
             "nt": _JNT(jnp.asarray(arrs["m"]), None, jnp.asarray(arrs["c"]))}
    ttree = {"z": torch.from_numpy(arrs["z"]), "b": [torch.from_numpy(arrs["a"])],
             "nt": _NT(torch.from_numpy(arrs["m"]), None, torch.from_numpy(arrs["c"]))}
    jspec, tspec = jflatten.flatten_spec(jtree), tflatten.flatten_spec(ttree)
    assert (tspec.shapes, tspec.offsets) == (jspec.shapes, jspec.offsets)
    np.testing.assert_array_equal(tspec.pack(ttree).numpy(), np.asarray(jspec.pack(jtree)))


def test_unpack_returns_views_and_round_trips(lm_params):
    _, tparams = lm_params
    flat = tflatten.pack_params(tparams, device=CPU)
    tree = flat.unpack()
    assert torch.equal(tflatten.flatten_spec(tree).pack(tree), flat.buf)
    flat.buf[0] = 123.0                                  # a write through the buffer...
    leaves, _ = tflatten.tree_flatten(tree)
    assert leaves[0].reshape(-1)[0] == 123.0             # ...shows in the first leaf


def test_unpacked_leaf_gradient_is_the_packed_gradient():
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.tensor(2.0)}
    spec = tflatten.flatten_spec(tree)
    leaf = spec.pack(tree).requires_grad_(True)
    p = spec.unpack(leaf)
    (p["w"].sum() * p["b"]).backward()
    # jax order: "b" (sorted) first, then "w"
    torch.testing.assert_close(leaf.grad, torch.tensor([15.0] + [2.0] * 6))


def test_validation():
    spec = tflatten.flatten_spec({"w": torch.zeros(3)})
    with pytest.raises(ValueError):
        spec.pack({"w": torch.zeros(4)})
    with pytest.raises(ValueError):
        spec.pack({"v": torch.zeros(3)})
    with pytest.raises(TypeError):
        tflatten.flatten_spec({"w": torch.zeros(3, dtype=torch.float64)})
    with pytest.raises(ValueError):
        spec.unpack(torch.zeros(5))
    flat = tflatten.pack_params({"w": torch.zeros(3)}, device=CPU)
    for storage in (torch.float16, "int4", "bfloat16"):     # not a bank storage of the port
        with pytest.raises(ValueError):
            tflatten.init_flat_bank(flat, 2, storage)


def test_init_flat_bank_rows_are_the_buffer():
    flat = tflatten.pack_params({"w": torch.arange(5.0)}, device=CPU)
    bank = tflatten.init_flat_bank(flat, 3)
    assert bank.shape == (3, 5) and bank.is_contiguous()
    assert all(torch.equal(row, flat.buf) for row in bank)
    bank[1, 0] = -1.0                                    # rows are copies
    assert flat.buf[0] == 0.0 and bank[0, 0] == 0.0
