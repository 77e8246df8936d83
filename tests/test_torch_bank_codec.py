"""The port's bank_codec family (repro_torch.kernels.bank_codec) against the
reference's (repro.kernels.bank_codec) on the CPU.

The port's plain versions (ref.py, and ops.py on CPU tensors) are held
against the reference's ops in both of its off-TPU backends: the jnp
oracle (interpret="oracle") and the Pallas kernels in interpret mode
(interpret=True, at the padded (R, 1024) layout), on the same numpy rows
and keys. Codes and scales must be equal exactly: the stochastic-rounding
bits are the same counter stream, and every float op is the same IEEE op.
The error row agrees exactly with the oracle and within 2**-22 * max|x|
with interpret mode, where XLA may contract x - q*scale into an FMA. The
CUDA kernels run only on a card: tests/test_torch_cuda.py and
chip_smoke.py hold them against these plain versions there.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federation.deep import _CODEC_SALT as SALT
from repro.kernels.bank_codec import kernel as jkernel
from repro.kernels.bank_codec import ops as jops
from repro.kernels.bank_codec import ref as jref
from repro_torch import random as trandom
from repro_torch.kernels import _build
from repro_torch.kernels.bank_codec import ops as tops
from repro_torch.kernels.bank_codec import ref as tref

P_RAGGED = 5003
FMTS = ("int8", "fp8")


def _row(p=P_RAGGED, seed=0, scale=2.5):
    x = (np.random.default_rng(seed).standard_normal(p) * scale).astype(np.float32)
    x[:6] = [0.0, -0.0, 1e-9, -3e-12, 0.0, 0.0]         # zeros and values below the fp8 grid
    return x


def _bytes(a):
    """Codes of either package as int32 (fp8 as its uint8 bit pattern)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return (a if a.dtype == np.int8 else a.view(np.uint8)).astype(np.int32)


@pytest.mark.parametrize("interp", ["oracle", True])
@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("fmt", FMTS)
def test_encode_decode_match_reference(fmt, deterministic, interp):
    x = _row()
    seed_key = 3
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed_key), SALT)
    jc, js, je = jops.encode_row(jnp.asarray(x), None if deterministic else jkey, fmt,
                                 deterministic=deterministic, block_rows=8, interpret=interp)
    tc, ts, te = tops.encode_row(torch.from_numpy(x), trandom.PRNGKey(seed_key, device="cpu"),
                                 fmt, deterministic=deterministic)
    assert tc.dtype == tops.code_dtype(fmt) and ts.shape == (1,) and te.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(tc), _bytes(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tol = 0.0 if interp == "oracle" else 2.0 ** -22 * float(np.abs(x).max())
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=tol)
    jd = jops.decode_row(jc, js, fmt, block_rows=8, interpret=interp)
    np.testing.assert_array_equal(tops.decode_row(tc, ts, fmt).numpy(), np.asarray(jd))
    # the error row is the decode error, in f32
    np.testing.assert_array_equal(te.numpy(), x - tops.decode_row(tc, ts, fmt).numpy())


@pytest.mark.parametrize("fmt", FMTS)
def test_per_block_scales_match_reference(fmt):
    x = _row(seed=1)
    x[:1000] *= 1e-3                                       # a block of small magnitudes
    key = jax.random.fold_in(jax.random.PRNGKey(8), SALT)
    jc, js, je = jops.encode_row(jnp.asarray(x), key, fmt, block_elems=1000,
                                 interpret="oracle")
    tc, ts, te = tops.encode_row(torch.from_numpy(x), trandom.PRNGKey(8, device="cpu"), fmt,
                                 block_elems=1000)
    assert ts.shape == (tops.n_scales(P_RAGGED, 1000),) == (6,)
    np.testing.assert_array_equal(_bytes(tc), _bytes(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(
        tops.decode_row(tc, ts, fmt, block_elems=1000).numpy(),
        np.asarray(jops.decode_row(jc, js, fmt, block_elems=1000, interpret="oracle")))


def test_counter_bits_and_seed_match_reference():
    for seed in (0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x12345678):
        ref = np.asarray(jref.counter_bits(jnp.uint32(seed), (3, 1000)))
        out = tref.counter_bits(torch.tensor(seed, dtype=torch.int64), 3000)
        np.testing.assert_array_equal(out.to(torch.int64).numpy(), ref.reshape(-1))
    # the codec's salt is the one the reference's engine folds into the key
    assert tref.CODEC_SALT == SALT
    for k in (0, 5, 0xFFFFFFFF):
        jkey = jax.random.PRNGKey(k)
        tkey = trandom.PRNGKey(k, device="cpu")
        assert int(tref.sr_seed(tkey)) == int(
            jax.random.bits(jax.random.fold_in(jkey, SALT), (), jnp.uint32))
    u = tref.u01_from_bits(tref.det_bits((4,)))
    assert torch.equal(u, torch.full((4,), 0.5))
    with pytest.raises(ValueError):
        tref.counter_bits(torch.tensor(0), 1 << 32)


def test_all_256_fp8_patterns_decode_exactly():
    pats = np.arange(256, dtype=np.uint8)
    out = tref.fp8_to_f32(torch.from_numpy(pats)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jref.fp8_to_f32(jnp.asarray(pats))))
    # and as the e4m3fn type decodes them, but for its NaN patterns, which
    # the encoder never writes (it clips to 448 = 0x7E)
    native = torch.from_numpy(pats).view(torch.float8_e4m3fn).to(torch.float32).numpy()
    finite = (pats & 0x7F) != 0x7F
    np.testing.assert_array_equal(out[finite], native[finite])
    np.testing.assert_array_equal(np.signbit(out[finite]), np.signbit(native[finite]))
    # decode through the wrapper with a unit scale
    one = torch.ones(1)
    np.testing.assert_array_equal(tops.decode_row(torch.from_numpy(pats), one, "fp8").numpy(),
                                  out)


def test_fp8_rounding_edges():
    # 448 keeps 0x7E (p = 0 although 0x7F is the upper pattern); subnormals
    # floor onto m * 2**-9; values already on the grid keep their code
    y = torch.tensor([448.0, -448.0, 2.0 ** -9, 3.5 * 2.0 ** -9, 2.0 ** -6, 1.0, 416.0, 0.0])
    for u in (0.0, 0.999):
        codes = tref.fp8_sr(y, torch.full_like(y, u))
        ref = np.asarray(jref.fp8_sr(jnp.asarray(y.numpy()), jnp.full(y.shape, u, jnp.float32)))
        np.testing.assert_array_equal(codes.numpy(), ref)
    # u < p takes the upper pattern: u = 0 rounds every off-grid value up
    down = tref.fp8_sr(y, torch.full_like(y, 0.999)).numpy()
    up = tref.fp8_sr(y, torch.zeros_like(y)).numpy()
    assert down.tolist() == [0x7E, 0xFE, 0x01, 0x03, 0x08, 0x38, 0x7D, 0x00]
    assert up.tolist() == [0x7E, 0xFE, 0x01, 0x04, 0x08, 0x38, 0x7D, 0x00]


def test_row_scale_matches_reference_kernel_and_keeps_nan():
    x = _row(seed=2)
    for fmt in FMTS:
        ref = jkernel.row_scale_2d(jnp.asarray(np.pad(x, (0, 8 * 1024 - x.size))).reshape(-1, 1024),
                                   jref.QMAX[fmt], block_rows=8, interpret=True)
        np.testing.assert_array_equal(tops.row_scale(torch.from_numpy(x), fmt).numpy(),
                                      np.asarray(ref).reshape(1))
    zero = tops.row_scale(torch.zeros(10), "int8")
    assert torch.equal(zero, torch.tensor([1e-30]) / torch.tensor([127.0]))
    x[17] = np.nan
    assert bool(torch.isnan(tops.row_scale(torch.from_numpy(x), "int8")).all())
    assert bool(jnp.isnan(jref.row_scales_ref(jnp.asarray(x).reshape(1, -1), 127.0)).all())


def test_wrappers_validate_format_and_device():
    x = torch.zeros(8)
    with pytest.raises(ValueError):
        tops.encode_row(x, None, "int4", deterministic=True)
    with pytest.raises(ValueError):
        tops.decode_row(torch.zeros(8, dtype=torch.int8), torch.ones(1), "e5m2")
    with pytest.raises(ValueError, match="not supported"):
        tops.row_scale(torch.zeros(8, device="meta"), "int8")
    assert tops.code_dtype("int8") == torch.int8 and tops.code_dtype("fp8") == torch.uint8
    assert tops.n_scales(10, None) == 1 and tops.n_scales(10, 3) == 4


def test_stale_library_follows_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    common = tmp_path / "common"
    common.mkdir()
    (common / "shared.cuh").write_text("// nothing\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cstdint>\n#include "common/shared.cuh"\n')
    lib = tmp_path / "libk.so"
    assert _build.is_stale(lib, src)                               # not built yet
    lib.write_text("")
    for f, t in ((src, 100), (common / "shared.cuh", 100), (lib, 200)):
        os.utime(f, (t, t))
    assert not _build.is_stale(lib, src)
    os.utime(common / "shared.cuh", (300, 300))                    # an edited shared header
    assert _build.is_stale(lib, src)
    os.utime(common / "shared.cuh", (100, 100))
    os.utime(src, (300, 300))                                      # an edited source
    assert _build.is_stale(lib, src)


def test_kernel_sources_include_the_shared_threefry_header():
    from repro_torch.kernels.bank_codec import kernel as bk
    from repro_torch.kernels.dp_clip_noise import kernel as dk
    header = _build.KERNELS_DIR / "common" / "threefry.cuh"
    assert header in set(_build.KERNELS_DIR.rglob("*.cuh"))       # counted by is_stale
    for source in (bk.SOURCE, dk.SOURCE):
        assert '#include "common/threefry.cuh"' in source.read_text()
