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
        spec.pack({"w": torch.zeros(3, dtype=torch.bfloat16)})     # not the spec's dtype
    for dtype in (torch.float64, torch.int32, torch.float8_e4m3fn):
        with pytest.raises(TypeError, match="packable"):          # as the reference's
            tflatten.flatten_spec({"w": torch.zeros(3, dtype=dtype)})
        with pytest.raises(TypeError):
            jflatten.flatten_spec({"w": jnp.zeros(3, _JAX_DTYPES[dtype])})
    with pytest.raises(ValueError):
        spec.unpack(torch.zeros(5))
    flat = tflatten.pack_params({"w": torch.arange(3.0)}, device=CPU)
    for storage in ("int4", torch.float64, torch.int8):    # not a bank storage of the port
        with pytest.raises(ValueError):
            tflatten.init_flat_bank(flat, 2, storage)
    with pytest.raises(ValueError):
        jflatten.as_bank_codec("int4")
    # every packable float is a dense bank, by dtype or by the reference's name
    for storage, dtype in ((torch.float16, torch.float16), ("float16", torch.float16),
                           ("bfloat16", torch.bfloat16), (torch.bfloat16, torch.bfloat16),
                           ("float32", torch.float32), (None, torch.float32)):
        assert tflatten.as_bank_codec(storage) is None
        assert jflatten.as_bank_codec(storage if isinstance(storage, str) or storage is None
                                      else "float16") is None
        bank = tflatten.init_flat_bank(flat, 2, storage)
        assert bank.dtype == dtype and torch.equal(bank.float(), flat.buf.expand(2, 3))


# the reference side of each refused dtype: jax without x64 makes a float64
# array float32, which the reference packs, so int16 stands in for it there
_JAX_DTYPES = {torch.float64: jnp.int16, torch.int32: jnp.int32,
               torch.float8_e4m3fn: jnp.float8_e4m3fn}


# --------------------------- bf16 and f16 leaves ---------------------------
def _mixed_arrays(seed=0):
    import ml_dtypes
    rng = np.random.default_rng(seed)
    return {"z": rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16),
            "a": np.float16(rng.standard_normal()),
            "m": rng.standard_normal(4).astype(np.float32),
            "h": (rng.standard_normal((3, 2)) * 100).astype(np.float16)}


def test_mixed_dtype_tree_packs_bit_equal_to_the_reference():
    # the reference's test_flatten.py mixed tree: f32, bf16 and f16 leaves,
    # a scalar among them; the packed buffers equal bit for bit, and both
    # specs name the same dtypes
    arrs = _mixed_arrays()
    jtree = {k: jnp.asarray(v) for k, v in arrs.items()}
    ttree = params_from_numpy(arrs, device=CPU)
    jspec, tspec = jflatten.flatten_spec(jtree), tflatten.flatten_spec(ttree)
    assert (tspec.shapes, tspec.offsets, tspec.size) == (jspec.shapes, jspec.offsets, jspec.size)
    assert [str(d).replace("torch.", "") for d in tspec.dtypes] == [d.name for d in jspec.dtypes]
    buf = tflatten.pack_params(ttree, device=CPU).buf
    assert buf.dtype == torch.float32
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jflatten.pack_params(jtree).buf))
    back = tspec.unpack(buf)                               # exact round trip, in the dtypes
    jback = jspec.unpack(jnp.asarray(buf.numpy()))
    for k, leaf in back.items():
        assert leaf.dtype == ttree[k].dtype and torch.equal(leaf, ttree[k]), k
        np.testing.assert_array_equal(leaf.float().numpy(), np.asarray(jback[k], np.float32))


def test_unpack_gives_f32_views_and_narrow_casts():
    ttree = params_from_numpy(_mixed_arrays(1), device=CPU)
    flat = tflatten.pack_params(ttree, device=CPU)
    tree = flat.unpack()
    assert tree["m"].dtype == torch.float32 and tree["m"]._base is not None
    assert tree["m"].data_ptr() == flat.buf.data_ptr() + 4 * flat.spec.offsets[2]
    flat.buf[flat.spec.offsets[2]] = 7.0                   # the f32 leaf is a view...
    assert tree["m"][0] == 7.0
    assert tree["h"].dtype == torch.float16 and tree["z"].dtype == torch.bfloat16
    flat.buf[flat.spec.offsets[1]] += 1.0                  # ...a narrow leaf a copy
    assert torch.equal(tree["h"], ttree["h"])
    # the f32 views of pack_f32's inverse, whatever the leaves' dtypes
    side = flat.spec.unpack_f32(flat.buf)
    assert all(leaf.dtype == torch.float32 for leaf in side.values())
    assert torch.equal(flat.spec.pack_f32(side), flat.buf)


def test_gradient_through_a_narrow_leaf_is_the_widened_leaf_gradient():
    # the packed gradient of a loss on unpacked bf16/f16 leaves equals each
    # leaf's own gradient (in its dtype) widened to f32
    ttree = params_from_numpy(_mixed_arrays(2), device=CPU)
    spec = tflatten.flatten_spec(ttree)

    def loss(p):
        return ((p["z"].float() ** 2).sum() * p["a"].float() + (p["h"].float() * 3.0).sum()
                + torch.sin(p["m"]).sum())
    leaf = spec.pack(ttree).requires_grad_(True)
    loss(spec.unpack(leaf)).backward()
    live = {k: v.detach().clone().requires_grad_(True) for k, v in ttree.items()}
    loss(live).backward()
    want = spec.pack_f32({k: v.grad for k, v in live.items()})
    assert all(live[k].grad.dtype == ttree[k].dtype for k in live)
    assert torch.equal(leaf.grad, want)


def test_init_flat_bank_rows_are_the_buffer():
    flat = tflatten.pack_params({"w": torch.arange(5.0)}, device=CPU)
    bank = tflatten.init_flat_bank(flat, 3)
    assert bank.shape == (3, 5) and bank.is_contiguous()
    assert all(torch.equal(row, flat.buf) for row in bank)
    bank[1, 0] = -1.0                                    # rows are copies
    assert flat.buf[0] == 0.0 and bank[0, 0] == 0.0
