"""The port's dp_clip_noise family (repro_torch.kernels.dp_clip_noise)
against the reference's (repro.kernels.dp_clip_noise) on the CPU.

The plain versions are held against the reference's jnp oracles and its
Pallas kernels in interpret mode, on the same uint32 bits. Tolerances:
the element-wise float ops are the same op sequence, so the only
difference is log1p in the Laplace transform, which may differ by an ulp
(rtol 1e-6); the squared norm sums in another order (rtol 1e-5). The
CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
holds them against the plain versions there, and chip_smoke.py does so
at the main path's full width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dp_clip_noise import kernel as jkernel
from repro.kernels.dp_clip_noise import ops as jops
from repro.kernels.dp_clip_noise import ref as jref
from repro_torch import random as trandom
from repro_torch.kernels.dp_clip_noise import kernel as tkernel
from repro_torch.kernels.dp_clip_noise import ops as tops
from repro_torch.kernels.dp_clip_noise import ref as tref

CPU = "cpu"
ROUND = dict(sigma=1e-2, lr_own=0.3, lr_l=0.2, n_owners=4, theta_max=100.0)


def _words(n, seed=0):
    w = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64)
    edges = np.array([0, 1, 0x7FFFFF00, 0x80000000, 0x800000FF, 0xFFFFFFFF], np.uint64)
    return np.concatenate([edges, w]).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_laplace_from_bits_matches_reference():
    bits = _words(1 << 16)
    out = tref.laplace_from_bits_ref(_t(bits)).numpy()
    ref = np.asarray(jref.laplace_from_bits(jnp.asarray(bits)))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    # top-24-bits midpoint: v = 0 exactly, and sign(0) = 0 as jnp.sign
    assert out[3] == ref[3] == 0.0 and out[4] == 0.0


@pytest.mark.parametrize("gain,ns,w,theta_max", [
    (0.5, 1.3, 0.25, 100.0),
    (1.0, 0.0, 1.0, 100.0),
    (0.25, 4.0, 0.0625, 0.05),          # the projection clips most elements
])
def test_dp_round_ref_matches_reference_ref(gain, ns, w, theta_max):
    n = 5000
    tb, acc, bits = _f32(n, 1), _f32(n, 2), _words(n - 6, 3)
    kw = dict(ROUND, theta_max=theta_max)
    new_l, new_i = tref.dp_round_ref(_t(tb), _t(acc), _t(bits), gain,
                                     torch.tensor(ns), torch.tensor(w), **kw)
    ref_l, ref_i = jref.dp_round_ref(jnp.asarray(tb), jnp.asarray(acc), jnp.asarray(bits),
                                     gain, jnp.float32(ns), jnp.float32(w), **kw)
    np.testing.assert_allclose(new_l.numpy(), np.asarray(ref_l), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(new_i.numpy(), np.asarray(ref_i), rtol=1e-6, atol=1e-7)


def test_dp_round_ref_matches_pallas_kernel_interpret():
    R = 16
    tb, acc = _f32((R, jkernel.LANES), 4), _f32((R, jkernel.LANES), 5)
    bits = _words(R * jkernel.LANES - 6, 6).reshape(R, jkernel.LANES)
    one = lambda v: jnp.full((1, 1), v, jnp.float32)   # noqa: E731
    ref_l, ref_i = jkernel.dp_round_2d(jnp.asarray(tb), jnp.asarray(acc), jnp.asarray(bits),
                                       one(0.5), one(0.9), one(0.125), block_rows=8,
                                       interpret=True, **ROUND)
    new_l, new_i = tref.dp_round_ref(_t(tb), _t(acc), _t(bits), torch.tensor(0.5),
                                     torch.tensor(0.9), torch.tensor(0.125), **ROUND)
    np.testing.assert_allclose(new_l.numpy(), np.asarray(ref_l), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(new_i.numpy(), np.asarray(ref_i), rtol=1e-6, atol=1e-7)


def test_sqnorm_ref_matches_pallas_kernel_interpret():
    g = _f32((16, jkernel.LANES), 7)
    ref = float(jkernel.sqnorm_2d(jnp.asarray(g), block_rows=8, interpret=True))
    assert float(tref.sqnorm_ref(_t(g))) == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("p", [1, 1031, 3 * 1024 + 17])
def test_dp_round_flat_cpu_matches_reference_oracle(p):
    # same key -> same bits(key, (P,)) draw at the unpadded shape
    tb, acc = _f32(p, 8), _f32(p, 9)
    new_l, new_i = tops.dp_round_flat(_t(tb), _t(acc), trandom.PRNGKey(12, device=CPU),
                                      torch.tensor(0.5), torch.tensor(0.9),
                                      torch.tensor(0.125), **ROUND)
    ref_l, ref_i = jops.dp_round_flat(jnp.asarray(tb), jnp.asarray(acc),
                                      jax.random.PRNGKey(12), 0.5, jnp.float32(0.9),
                                      jnp.float32(0.125), interpret="oracle", **ROUND)
    np.testing.assert_allclose(new_l.numpy(), np.asarray(ref_l), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(new_i.numpy(), np.asarray(ref_i), rtol=1e-6, atol=1e-7)


def test_dp_round_flat_noise_is_the_key_stream():
    # acc = theta_bar = 0 exposes the noise term: new_i = -lr_own * w * ns * Lap(bits)
    p, ns, w = 4096, 2.0, 0.25
    z = torch.zeros(p)
    key = trandom.PRNGKey(3, device=CPU)
    _, new_i = tops.dp_round_flat(z, z, key, torch.tensor(1.0), torch.tensor(ns),
                                  torch.tensor(w), **ROUND)
    lap = tref.laplace_from_bits_ref(trandom.bits(key, (p,)))
    torch.testing.assert_close(new_i, -ROUND["lr_own"] * (w * (ns * lap)), rtol=0, atol=0)


def test_fused_sqnorm_cpu_matches_reference_oracle():
    g = _f32(10007, 10)
    ref = float(jops.fused_sqnorm_tree({"g": jnp.asarray(g)}, interpret="oracle"))
    assert float(tops.fused_sqnorm(_t(g))) == pytest.approx(ref, rel=1e-5)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    before = dict(tkernel.launches)
    tops.fused_sqnorm(torch.ones(8))
    tops.dp_round_flat(torch.ones(8), torch.ones(8), trandom.PRNGKey(0, device=CPU), 1.0,
                       torch.tensor(1.0), torch.tensor(1.0), **ROUND)
    assert tkernel.launches == before


@pytest.mark.parametrize("op", ["dp_round_flat", "fused_sqnorm"])
def test_other_devices_raise(op):
    t = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        if op == "fused_sqnorm":
            tops.fused_sqnorm(t)
        else:
            tops.dp_round_flat(t, t, trandom.PRNGKey(0, device=CPU), 1.0, 1.0, 1.0, **ROUND)


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        tkernel.sqnorm_cuda(torch.ones(4))
    with pytest.raises(ValueError):
        one = torch.ones(1)
        tkernel.dp_round_cuda(torch.ones(4), torch.ones(4), trandom.PRNGKey(0, device=CPU),
                              one, one, one, sigma=1.0, lr_own=1.0, lr_l=1.0, inv_2n=0.5,
                              theta_max=1.0)
