"""The backward of the SSD chunk scan on the CPU, in toy sizes.

`ref.ssd_chunk_scan_bwd_ref` (the plain backward the card's kernel is held
against) against autograd through `ref.ssd_chunk_scan_ref`; the autograd
op `ops.SSDChunkScan` with `ops.combine_chunks` (what `ops.ssd_chunked`
runs on the card, here with its plain bodies) against `jax.vjp` of the
reference's `repro.models.ssm.ssd_chunked`, on numpy inputs from one seed;
and `torch.func.vmap(torch.func.grad(...))` through the op against a loop
of single-example gradients.

Tolerances: f32 within 2e-5 of each output's largest value (the closed
form and autograd, or the two packages, sum the same products in other
orders; the cotangent of cum sums up to Q = 32 terms of either sign);
bf16 inputs within one bf16 step of their f32 results as well (both sides
compute in f32 and round the cotangents of v, k and q to bf16). The vmap
gradients equal the loop's bit for bit: the vmap rule runs the same plain
bodies on the folded batch.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssm_scan import ops, ref


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_inputs(B, S, H, N, P, bcast, seed):
    """Mamba2-like scan inputs from numpy: ld = -softplus(x), g = sigmoid(x);
    k and q (B, S, 1, N) when they broadcast over the heads."""
    rng = np.random.default_rng(seed)
    kh = 1 if bcast else H
    v = rng.standard_normal((B, S, H, P), dtype=np.float32)
    k = rng.standard_normal((B, S, kh, N), dtype=np.float32)
    q = rng.standard_normal((B, S, kh, N), dtype=np.float32)
    ld = -np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
    g = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H))))).astype(np.float32)
    return v, ld, k, q, g


def _close(got, want, dtype=torch.float32):
    atol = 2e-5 * float(want.float().abs().max()) + 1e-6
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# (B, S, H, N, P, chunk, k and q broadcast): whole chunks, a ragged last
# chunk, one ragged chunk shorter than `chunk`, per-head k and q
SHAPES = [(2, 64, 3, 8, 16, 32, True), (1, 45, 2, 8, 8, 16, True), (2, 10, 2, 16, 8, 16, False),
          (1, 40, 2, 16, 16, 16, False)]


@pytest.mark.parametrize("B,S,H,N,P,Q,bcast", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_equals_autograd_through_the_plain_forward(B, S, H, N, P, Q, bcast, dtype):
    v, ld, k, q, g = (torch.from_numpy(a) for a in _np_inputs(B, S, H, N, P, bcast, seed=S))
    v, k, q = (t.to(dtype) for t in (v, k, q))
    leaves = [t.clone().requires_grad_() for t in (v, ld, k, q, g)]
    kk, qq = (t.expand(B, S, H, N) for t in leaves[2:4])
    outs = ref.ssd_chunk_scan_ref(leaves[0], leaves[1], kk, qq, leaves[4], Q)
    gen = torch.Generator().manual_seed(1)
    cots = [torch.randn(o.shape, generator=gen) for o in outs]
    want = torch.autograd.grad(outs, leaves, cots)
    got = ref.ssd_chunk_scan_bwd_ref(*cots, v, ld, k.expand(B, S, H, N), q.expand(B, S, H, N),
                                     g, Q)
    for name, a, b, leaf in zip("v ld k q g".split(), got, want, leaves):
        assert a.dtype == leaf.dtype, name
        if bcast and name in ("k", "q"):
            assert tuple(a.shape) == (B, S, H, N)       # dense; expand's backward sums
            a = a.float().sum(dim=2, keepdim=True)
        _close(a, b, dtype if name in ("v", "k", "q") else torch.float32)


def _torch_scan_through_the_op(v, ld, k, q, g, h0, chunk):
    B, S, H, _ = v.shape
    N = k.shape[-1]
    Q = min(chunk, S)
    kk, qq = k.expand(B, S, H, N), q.expand(B, S, H, N)
    parts = ops.SSDChunkScan.apply(v, ld, kk, qq, g, Q)
    return ops.combine_chunks(*parts, qq, Q, h0)


@pytest.mark.parametrize("B,S,H,N,P,Q,bcast", SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_the_op_and_combine_chunks_match_jax_vjp_of_the_reference(B, S, H, N, P, Q, bcast,
                                                                  with_h0):
    arrays = _np_inputs(B, S, H, N, P, bcast, seed=S + 7)
    rng = np.random.default_rng(S + 8)
    h0 = rng.standard_normal((B, H, N, P), dtype=np.float32) if with_h0 else None
    ry = rng.standard_normal((B, S, H, P), dtype=np.float32)
    rh = rng.standard_normal((B, H, N, P), dtype=np.float32)

    def jax_scan(v, ld, k, q, g, *h):
        k, q = (jnp.broadcast_to(x, (B, S, H, N)) for x in (k, q))
        return jax_ssd_chunked(v, ld, k, q, g, chunk=Q, h0=h[0] if h else None)

    jargs = [jnp.asarray(a) for a in arrays] + ([jnp.asarray(h0)] if with_h0 else [])
    (jy, jh), vjp = jax.vjp(jax_scan, *jargs)
    jgrads = vjp((jnp.asarray(ry), jnp.asarray(rh)))

    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    th0 = torch.from_numpy(h0).requires_grad_() if with_h0 else None
    y, h = _torch_scan_through_the_op(*leaves, th0, Q)
    _close(y.detach(), torch.from_numpy(np.array(jy)))
    _close(h.detach(), torch.from_numpy(np.array(jh)))
    inputs = leaves + ([th0] if with_h0 else [])
    grads = torch.autograd.grad((y * torch.from_numpy(ry)).sum() + (h * torch.from_numpy(rh)).sum(),
                                inputs)
    for a, b in zip(grads, jgrads):
        assert tuple(a.shape) == b.shape
        _close(a, torch.from_numpy(np.array(b)))


def test_vmap_of_grad_through_the_op_matches_single_example_grads(monkeypatch):
    """The "example" granularity's torch.func.vmap(grad) through the op: its
    vmap rules fold the mapped axis into the batch, so the forward and the
    backward each run once, on all examples together."""
    n, S, H, N, P, Q = 3, 40, 2, 8, 16, 16
    v, ld, k, q, g = (torch.from_numpy(a) for a in _np_inputs(n, S, H, N, P, True, seed=11))
    calls = []

    def counted(fn, name):
        def wrapped(*args):
            calls.append((name, args[0].shape[0]))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(ops, "ssd_chunk_scan_ref", counted(ref.ssd_chunk_scan_ref, "fwd"))
    monkeypatch.setattr(ops, "ssd_chunk_scan_bwd_ref",
                        counted(ref.ssd_chunk_scan_bwd_ref, "bwd"))

    def loss(v1, k1, ld1, q1, g1):
        y, h = _torch_scan_through_the_op(v1[None], ld1[None], k1[None], q1[None], g1[None],
                                          None, Q)
        return (y ** 2).sum() + h.sum()

    gv, gk = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(v, k, ld, q, g)
    assert calls == [("fwd", n), ("bwd", n)]
    for i in range(n):
        vi, ki = v[i].clone().requires_grad_(), k[i].clone().requires_grad_()
        a, b = torch.autograd.grad(loss(vi, ki, ld[i], q[i], g[i]), (vi, ki))
        assert torch.equal(gv[i], a) and torch.equal(gk[i], b)


def test_the_op_has_no_second_derivative():
    v, ld, k, q, g = (torch.from_numpy(a) for a in _np_inputs(1, 16, 2, 8, 8, False, seed=3))
    v.requires_grad_()
    y = ops.SSDChunkScan.apply(v, ld, k, q, g, 8)[0]
    (gv,) = torch.autograd.grad((y ** 2).sum(), v, create_graph=True)
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.autograd.grad(gv.sum(), v)


def test_the_op_refuses_other_devices():
    # meta runs the kernel ops' fakes (shapes only), as a traced step needs
    v = torch.zeros((1, 4, 1, 8), device="meta")
    shapes = [tuple(t.shape) for t in ops.SSDChunkScan.apply(v, v[..., 0], v, v, v[..., 0], 4)]
    assert shapes == [(1, 4, 1, 8), (1, 1, 1, 8, 8), (1, 4, 1), (1, 1, 1)]
    with pytest.raises(ValueError, match="not supported"):
        ops._backend(None, None, SimpleNamespace(device=torch.device("xpu")), "SSDChunkScan")
