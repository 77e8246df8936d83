"""The port's threefry key stream against jax.random, key for key.

Integer streams must match exactly: they carry the owner schedules, the
round keys and the Laplace bits, and so every trajectory comparison. The
float draws are jax's algorithms on those bits: `uniform` matches exactly
(XLA's fused multiply-add of the scaling included); `laplace` within 1 ulp
(torch's log1p against XLA's); `normal` within rtol 1e-4, because torch's
erfinv and XLA's single-precision erf_inv polynomial part by up to 6.7e-5
relative in the tails (|x| near 3.8, measured over 8 x 2^20 draws);
`exponential` within 1 ulp (a correctly rounded log1p against XLA's);
`gumbel` within 1e-6 absolute (its values reach about 15, where one ulp is
1e-6; near 0 the ulp count of a 1e-7 difference is meaningless). A batch of
keys gives, key for key, what jax's vmap over the keys gives: exactly for
the integer streams and uniform, within the same bounds for the rest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as trandom

CPU = "cpu"
SEEDS = [0, 1, 42, 2**31 - 1, 123456789]


def _key_pair(seed):
    return jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device=CPU)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    jk, tk = _key_pair(seed)
    assert tk.dtype == torch.uint32 and tk.shape == (2,)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
@pytest.mark.parametrize("num", [1, 2, 3, 7, 160])
def test_split(seed, num):
    jk, tk = _key_pair(seed)
    np.testing.assert_array_equal(trandom.split(tk, num).numpy(),
                                  np.asarray(jax.random.split(jk, num)))


def test_split_rows_unpack_like_jax():
    jk, tk = _key_pair(3)
    ja, jb = jax.random.split(jk)
    ta, tb = trandom.split(tk)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("data", [0, 1, 0x5142, 2**31, 2**32 - 1])
def test_fold_in(data):
    jk, tk = _key_pair(5)
    np.testing.assert_array_equal(trandom.fold_in(tk, data).numpy(),
                                  np.asarray(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (4097,)])
@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_bits(seed, shape):
    jk, tk = _key_pair(seed)
    out = trandom.bits(tk, shape)
    assert out.dtype == torch.uint32 and tuple(out.shape) == shape
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax.random.bits(jk, shape)))


def test_bits_of_split_keys_chain():
    # the round-key pattern of run_rounds: split(key, K)[k] -> bits
    jk, tk = _key_pair(4)
    jks, tks = jax.random.split(jk, 5), trandom.split(tk, 5)
    for k in range(5):
        np.testing.assert_array_equal(trandom.bits(tks[k], (33,)).numpy(),
                                      np.asarray(jax.random.bits(jks[k], (33,))))


# randint's two-draw modular algorithm, including spans whose squared
# multiplier wraps at 32 bits and spans that are not powers of two
@pytest.mark.parametrize("lo,hi", [(0, 4), (0, 32), (0, 7), (-5, 17), (0, 2**30 + 3),
                                   (100, 100 + 65537), (-2**31, -1)])
@pytest.mark.parametrize("seed", [0, 9])
def test_randint(seed, lo, hi):
    jk, tk = _key_pair(seed)
    out = trandom.randint(tk, (2000,), lo, hi)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jax.random.randint(jk, (2000,), lo, hi)))


def test_randint_rejects_empty_or_wide_spans():
    tk = trandom.PRNGKey(0, device=CPU)
    with pytest.raises(ValueError):
        trandom.randint(tk, (3,), 4, 4)
    with pytest.raises(ValueError):
        trandom.randint(tk, (3,), -2**31, 2**31 - 1)


def test_key_shape_is_checked():
    with pytest.raises(ValueError):
        trandom.bits(torch.zeros(3, dtype=torch.uint32), (2,))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.0, 0.5), (1e-3, 2.7), (-1e4, 1e4),
                                   (-1.0 + 2.0 ** -24, 1.0)])
@pytest.mark.parametrize("shape", [(1,), (3, 5), (1 << 16,)])
def test_uniform(shape, lo, hi):
    jk, tk = _key_pair(11)
    out = trandom.uniform(tk, shape, lo, hi)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_laplace_within_one_ulp(seed):
    jk, tk = _key_pair(seed)
    out = trandom.laplace(tk, (1 << 18,)).numpy()
    ref = np.asarray(jax.random.laplace(jk, (1 << 18,)))
    assert _ulps(out, ref).max() <= 1
    assert (out == ref).mean() > 0.9
    # a shape draws the words of its flat size, as jax's partitionable mode
    np.testing.assert_array_equal(trandom.laplace(tk, (2, 3)).numpy().reshape(-1),
                                  trandom.laplace(tk, (6,)).numpy())


@pytest.mark.parametrize("seed", [0, 7])
def test_normal(seed):
    jk, tk = _key_pair(seed)
    out = trandom.normal(tk, (1 << 18,)).numpy()
    ref = np.asarray(jax.random.normal(jk, (1 << 18,)))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)
    assert np.isfinite(out).all() and abs(out.std() - 1.0) < 0.01


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_exponential_within_one_ulp(seed):
    jk, tk = _key_pair(seed)
    out = trandom.exponential(tk, (1 << 18,)).numpy()
    ref = np.asarray(jax.random.exponential(jk, (1 << 18,)))
    assert _ulps(out, ref).max() <= 1 and (out == ref).mean() > 0.9
    assert out.min() >= 0.0 and abs(out.mean() - 1.0) < 0.01


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_gumbel_within_1e6(seed):
    jk, tk = _key_pair(seed)
    out = trandom.gumbel(tk, (1 << 18,)).numpy()
    ref = np.asarray(jax.random.gumbel(jk, (1 << 18,)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert (out == ref).mean() > 0.7 and abs(out.mean() - 0.5772) < 0.01


def test_batched_keys_match_vmap():
    jk, tk = _key_pair(21)
    jks, tks = jax.random.split(jk, 6), trandom.split(tk, 6)
    grid_j, grid_t = jks.reshape(2, 3, 2), tks.reshape(2, 3, 2)

    def vmap2(fn):
        return np.asarray(jax.vmap(jax.vmap(fn))(grid_j))

    np.testing.assert_array_equal(trandom.split(grid_t, 4).numpy(),
                                  vmap2(lambda k: jax.random.split(k, 4)))
    np.testing.assert_array_equal(trandom.fold_in(grid_t, 77).numpy(),
                                  vmap2(lambda k: jax.random.fold_in(k, 77)))
    np.testing.assert_array_equal(trandom.bits(grid_t, (5, 2)).numpy(),
                                  vmap2(lambda k: jax.random.bits(k, (5, 2))))
    np.testing.assert_array_equal(trandom.randint(grid_t, (9,), -3, 11).numpy(),
                                  vmap2(lambda k: jax.random.randint(k, (9,), -3, 11)))
    np.testing.assert_array_equal(trandom.uniform(grid_t, (7,), 0.5, 3.0).numpy(),
                                  vmap2(lambda k: jax.random.uniform(k, (7,), minval=0.5,
                                                                     maxval=3.0)))
    assert _ulps(trandom.laplace(grid_t, (4, 3)).numpy(),
                 vmap2(lambda k: jax.random.laplace(k, (4, 3)))).max() <= 1
    assert _ulps(trandom.exponential(grid_t, (50,)).numpy(),
                 vmap2(lambda k: jax.random.exponential(k, (50,)))).max() <= 1
    np.testing.assert_allclose(trandom.gumbel(grid_t, (50,)).numpy(),
                               vmap2(lambda k: jax.random.gumbel(k, (50,))), rtol=0, atol=1e-6)
    # fold_in broadcasts its data against the key's leading axes
    steps = np.arange(5)
    np.testing.assert_array_equal(
        trandom.fold_in(tks[:, None, :], torch.from_numpy(steps)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.vmap(lambda d: jax.random.fold_in(k, d))(
            jnp.asarray(steps)))(jks)))
    # each key of a batch gives what it gives alone
    for r in range(6):
        assert torch.equal(trandom.laplace(tks, (3,))[r], trandom.laplace(tks[r], (3,)))
