"""The port's chunked SSD scan (`models.ssm.ssd_chunked`, the plain
version of the ssm_scan kernel, and `kernels.ssm_scan.ops.ssd_chunked`,
which runs it on CPU tensors) against the reference's Pallas kernel in
interpret mode (`ssd_chunked_pallas`) and its oracle (`ssd_chunked`), on
the reference's own sweep (ragged last chunk included), with and without
an initial state; and the one-token pieces (`ssd_step`, `causal_conv`,
`causal_conv_step`).

Tolerances: the reference's own test's absolute bounds
(tests/test_kernels.py), f32 within 1e-4 and bf16 inputs within 5e-2 (y is
rounded to bf16 on both sides), plus a relative 1e-5: the f32 sums over N
and over a chunk of up to 128 positions run in other orders, and at N = P
= 64 y reaches about 30, where 1e-4 is 3 ulp. The one-token pieces within
1e-5 (f32, a handful of operations).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import ssd_chunked_pallas
from repro.models import ssm as jssm
from repro_torch.kernels.ssm_scan import ops, ref
from repro_torch.models import ssm as tssm

SWEEP = [
    (2, 128, 3, 16, 32, 32),
    (1, 100, 2, 8, 16, 32),         # ragged last chunk
    (2, 64, 4, 64, 64, 64),
    (1, 256, 1, 32, 64, 128),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _softplus(x):
    return np.logaddexp(0.0, x).astype(np.float32)


def _inputs(B, S, H, N, P, seed):
    """v, ld, k, q, g as numpy f32, distributed as the reference test's."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((B, S, H, P)).astype(np.float32)
    k = rng.standard_normal((B, S, H, N)).astype(np.float32)
    q = rng.standard_normal((B, S, H, N)).astype(np.float32)
    ld = -_softplus(rng.standard_normal((B, S, H)))
    g = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H))))).astype(np.float32)
    return v, ld, k, q, g


def _f32(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("B,S,H,N,P,Q", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_chunked_matches_reference(B, S, H, N, P, Q, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    v, ld, k, q, g = _inputs(B, S, H, N, P, seed=S + N)
    jargs = (jnp.asarray(v, jdt), jnp.asarray(ld), jnp.asarray(k, jdt), jnp.asarray(q, jdt),
             jnp.asarray(g))
    targs = (torch.from_numpy(v).to(tdt), torch.from_numpy(ld), torch.from_numpy(k).to(tdt),
             torch.from_numpy(q).to(tdt), torch.from_numpy(g))
    y_k, h_k = ssd_chunked_pallas(*jargs, chunk=Q, interpret=True)
    y_r, h_r = jssm.ssd_chunked(*jargs, chunk=Q)
    for fn in (tssm.ssd_chunked, ops.ssd_chunked):
        y, h = fn(*targs, chunk=Q)
        assert y.dtype == tdt and h.dtype == torch.float32
        assert tuple(y.shape) == (B, S, H, P) and tuple(h.shape) == (B, H, N, P)
        for want_y, want_h in ((y_k, h_k), (y_r, h_r)):
            np.testing.assert_allclose(_f32(y), _f32(want_y), rtol=1e-5, atol=tol)
            np.testing.assert_allclose(_f32(h), _f32(want_h), rtol=1e-5, atol=tol)


@pytest.mark.parametrize("B,S,H,N,P,Q", SWEEP[:2])
def test_ssd_chunked_from_an_initial_state(B, S, H, N, P, Q):
    v, ld, k, q, g = _inputs(B, S, H, N, P, seed=7)
    h0 = np.random.default_rng(8).standard_normal((B, H, N, P)).astype(np.float32)
    y_r, h_r = jssm.ssd_chunked(*map(jnp.asarray, (v, ld, k, q, g)), chunk=Q,
                                h0=jnp.asarray(h0))
    y, h = ops.ssd_chunked(*map(torch.from_numpy, (v, ld, k, q, g)), chunk=Q,
                           h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=1e-4)
    # a scan split in two, the second half from the first half's state,
    # equals the whole scan (the chunk boundary falls at the split)
    half = S // 2 // Q * Q
    t = [torch.from_numpy(a) for a in (v, ld, k, q, g)]
    y1, h1 = ops.ssd_chunked(*(a[:, :half] for a in t), chunk=Q, h0=torch.from_numpy(h0))
    y2, h2 = ops.ssd_chunked(*(a[:, half:] for a in t), chunk=Q, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), atol=1e-4)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), atol=1e-4)


def test_head_broadcast_inputs_as_mamba2_gives_them():
    """k and q broadcast over the heads (stride-0 views, as mamba2_forward
    passes B and C) give what the materialized copies give."""
    v, ld, k, q, g = _inputs(2, 70, 3, 16, 32, seed=4)
    kb = torch.from_numpy(k[:, :, :1]).expand(-1, -1, 3, -1)
    qb = torch.from_numpy(q[:, :, :1]).expand(-1, -1, 3, -1)
    args = (torch.from_numpy(v), torch.from_numpy(ld))
    y1, h1 = ops.ssd_chunked(*args, kb, qb, torch.from_numpy(g), chunk=32)
    y2, h2 = ops.ssd_chunked(*args, kb.contiguous(), qb.contiguous(), torch.from_numpy(g),
                             chunk=32)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    torch.testing.assert_close(h1, h2, rtol=0, atol=0)


def test_models_ssd_chunked_is_the_kernels_plain_version(monkeypatch):
    """models.ssm exports the plain version from the kernel's ref.py, and
    mamba2_forward reaches the scan through the kernel's entry point."""
    assert tssm.ssd_chunked is ref.ssd_chunked and tssm.ssd_step is ref.ssd_step
    calls = []

    def spy(*a, **kw):
        calls.append(kw["chunk"])
        return ref.ssd_chunked(*a, **kw)

    monkeypatch.setattr(ops, "ssd_chunked", spy)
    from repro_torch.configs import SSMConfig
    s = SSMConfig(d_state=16, head_dim=32, chunk=32)
    p = tssm.init_mamba2(torch.Generator().manual_seed(0), 64, s)
    tssm.mamba2_forward(p, torch.randn(1, 40, 64), s)
    assert calls == [32]


def test_ssd_step_matches_reference():
    B, H, N, P = 2, 3, 8, 16
    rng = np.random.default_rng(5)
    h = rng.standard_normal((B, H, N, P)).astype(np.float32)
    v = rng.standard_normal((B, H, P)).astype(np.float32)
    ld = -_softplus(rng.standard_normal((B, H)))
    k, q = (rng.standard_normal((B, H, N)).astype(np.float32) for _ in range(2))
    g = rng.random((B, H)).astype(np.float32)
    y_r, h_r = jssm.ssd_step(*map(jnp.asarray, (h, v, ld, k, q, g)))
    y, h_new = tssm.ssd_step(*map(torch.from_numpy, (h, v, ld, k, q, g)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=1e-5)
    np.testing.assert_allclose(h_new.numpy(), np.asarray(h_r), atol=1e-5)


def test_ssd_steps_equal_the_chunked_scan():
    """Inside the port: S one-token steps give the chunked scan's y and
    final state (within 1e-4, as above)."""
    v, ld, k, q, g = map(torch.from_numpy, _inputs(1, 20, 2, 8, 16, seed=6))
    y, h_fin = tssm.ssd_chunked(v, ld, k, q, g, chunk=8)
    h = torch.zeros(1, 2, 8, 16)
    for t in range(20):
        yt, h = tssm.ssd_step(h, v[:, t], ld[:, t], k[:, t], q[:, t], g[:, t])
        torch.testing.assert_close(yt, y[:, t], rtol=0, atol=1e-4)
    torch.testing.assert_close(h, h_fin, rtol=0, atol=1e-4)


def test_causal_conv_and_its_step_match_reference():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 12, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    want = np.asarray(jssm.causal_conv(jnp.asarray(x), jnp.asarray(w)))
    got = tssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    state = rng.standard_normal((2, 3, 10)).astype(np.float32)
    y_r, s_r = jssm.causal_conv_step(jnp.asarray(state), jnp.asarray(x[:, 0]), jnp.asarray(w))
    y, s = tssm.causal_conv_step(torch.from_numpy(state), torch.from_numpy(x[:, 0]),
                                 torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=1e-5)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    # the step from a zero state, token by token, gives the whole conv
    st = torch.zeros(2, 3, 10)
    for t in range(12):
        yt, st = tssm.causal_conv_step(st, torch.from_numpy(x[:, t]), torch.from_numpy(w))
        np.testing.assert_allclose(yt.numpy(), got[:, t].numpy(), atol=1e-5)


def test_mamba2_block_matches_reference():
    """One Mamba2 block (forward and a decode step from the reference's
    state), weights from the reference's init, within 1e-5 (f32)."""
    from repro.configs.base import SSMConfig as JSSMConfig
    from repro_torch.configs import SSMConfig
    from repro_torch.convert import cache_from_numpy, params_from_numpy
    js, s = JSSMConfig(d_state=16, head_dim=32, chunk=32), SSMConfig(d_state=16, head_dim=32,
                                                                      chunk=32)
    jp = jssm.init_mamba2(jax.random.PRNGKey(1), 64, js, jnp.float32)
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert isinstance(p, tssm.Mamba2Params)
    x = np.random.default_rng(10).standard_normal((2, 45, 64)).astype(np.float32)
    want = np.asarray(jssm.mamba2_forward(jp, jnp.asarray(x), js))
    np.testing.assert_allclose(tssm.mamba2_forward(p, torch.from_numpy(x), s).numpy(), want,
                               atol=1e-5)
    jstate = jssm.init_mamba2_state(2, 64, js, dtype=jnp.float32)
    jstate = jssm.Mamba2State(jax.random.normal(jax.random.PRNGKey(2), jstate.h.shape),
                              jax.random.normal(jax.random.PRNGKey(3), jstate.conv.shape))
    out_r, st_r = jssm.mamba2_decode(jp, jnp.asarray(x[:, :1]), jstate, js)
    out, st = tssm.mamba2_decode(p, torch.from_numpy(x[:, :1]),
                                 cache_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                                  device="cpu"), s)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), atol=1e-5)
    np.testing.assert_allclose(st.h.numpy(), np.asarray(st_r.h), atol=1e-5)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(st_r.conv), atol=1e-5)


@pytest.mark.parametrize("B,S,H,N,P,Q", SWEEP)
def test_chunk_scan_plain_version_matches_reference_kernel(B, S, H, N, P, Q):
    """ssd_chunk_scan_ref (what the CUDA kernel computes, in the model
    layout) against the reference's Pallas kernel in interpret mode on the
    reference wrapper's chunked, zero-padded layout: y_intra, h_add, cum and
    tot (f32, within 1e-4 plus a relative 1e-5, as above)."""
    from repro.kernels.ssm_scan.kernel import ssd_chunk_scan
    v, ld, k, q, g = _inputs(B, S, H, N, P, seed=S + P)
    nc, pad = -(-S // Q), (-S) % Q

    def chunked(a):     # (B,S,H,F) -> (B,H,nc,Q,F), as ssd_chunked_pallas does
        a = np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
        return jnp.asarray(a.reshape(B, nc, Q, H, -1).transpose(0, 3, 1, 2, 4))

    y_k, h_k, cum_k, tot_k = ssd_chunk_scan(chunked(v), chunked(k), chunked(q),
                                            chunked(ld[..., None]), chunked(g[..., None]),
                                            interpret=True)
    y, h_add, cum, tot = ref.ssd_chunk_scan_ref(*map(torch.from_numpy, (v, ld, k, q, g)), Q)
    unchunk = (lambda a: np.asarray(a).transpose(0, 2, 3, 1, 4).reshape(B, nc * Q, H, -1)[:, :S])
    np.testing.assert_allclose(y.numpy(), unchunk(y_k), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(cum.numpy(), unchunk(cum_k)[..., 0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(h_add.numpy(), np.asarray(h_k).transpose(0, 2, 1, 3, 4),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tot.numpy(), np.asarray(tot_k).transpose(0, 2, 1, 3)[..., 0],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B,S,H,N,P,Q", SWEEP)
def test_kernel_epilogue_gives_the_scan(B, S, H, N, P, Q):
    """What ops.ssd_chunked runs on CUDA after the kernel (combine_chunks:
    the recurrence between chunks and the decayed queries against the
    carried states), fed with the kernel's plain version, equals the plain
    scan, with and without h0 (f32, within 1e-4 plus a relative 1e-5)."""
    t = list(map(torch.from_numpy, _inputs(B, S, H, N, P, seed=S + H)))
    h0 = torch.from_numpy(np.random.default_rng(3).standard_normal((B, H, N, P)).astype(np.float32))
    parts = ref.ssd_chunk_scan_ref(*t, min(Q, S))
    for init in (None, h0):
        y, h = ops.combine_chunks(*parts, t[3], min(Q, S), init)
        want_y, want_h = ref.ssd_chunked(*t, chunk=Q, h0=init)
        torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-4)
