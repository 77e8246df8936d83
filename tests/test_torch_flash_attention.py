"""The port's flash attention entry point (its plain version on CPU
tensors) against the reference's Pallas kernel in interpret mode and its
oracle, on the reference's own sweep (GQA, MQA, a ragged last block, hd
80, windows), and the port's two attention backends against each other.

Tolerances are the reference's own test's (tests/test_kernels.py): f32
within 2e-5 (softmax sums in other orders), bf16 within 2e-2 (outputs
rounded to bf16 on both sides). Inputs are made with numpy from a seed and
rounded to bf16 the same way in both packages.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import attention as tattn

SWEEP = [
    (2, 128, 4, 2, 64, None),
    (1, 256, 4, 4, 32, 64),
    (2, 96, 2, 1, 128, None),       # MQA + ragged final block
    (1, 128, 8, 8, 80, 32),         # non-128 head dim
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, Kv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd))]


def _f32(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("B,S,H,Kv,hd,win", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_matches_reference(B, S, H, Kv, hd, win, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(B, S, H, Kv, hd, seed=S + hd)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    kernel = jax_flash_attention(jq, jk, jv, causal=True, window=win, bq=64, bk=64,
                                 interpret=True)
    G = H // Kv
    oracle = jax_attention_ref(jq.transpose(0, 2, 1, 3),
                               jnp.repeat(jk, G, 2).transpose(0, 2, 1, 3),
                               jnp.repeat(jv, G, 2).transpose(0, 2, 1, 3),
                               causal=True, window=win).transpose(0, 2, 1, 3)
    out = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              causal=True, window=win)
    assert out.dtype == tdt and tuple(out.shape) == (B, S, H, hd)
    np.testing.assert_allclose(_f32(out), _f32(kernel), atol=tol)
    np.testing.assert_allclose(_f32(out), _f32(oracle), atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_reference_oracle(causal):
    q, k, v = _inputs(2, 40, 2, 2, 16, seed=3)
    to_bhsd = (lambda a: a.transpose(0, 2, 1, 3))
    want = jax_attention_ref(*(jnp.asarray(to_bhsd(a)) for a in (q, k, v)), causal=causal,
                             window=8)
    got = ref.attention_ref(*(torch.from_numpy(to_bhsd(a)) for a in (q, k, v)),
                            causal=causal, window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("S,win,kv_chunk", [(64, None, 1024), (80, None, 32), (80, 24, 32),
                                            (50, None, 16)])
def test_attention_forward_backends_agree(S, win, kv_chunk):
    """attention_forward with backend "jnp" (blockwise, kv-chunked) and
    "pallas" (the flash entry point) agree inside the port, ragged last kv
    chunk included, within 2e-5 (f32, other summation orders)."""
    d, H, Kv, hd = 64, 4, 2, 16
    rng = np.random.default_rng(S)
    p = tattn.AttnParams(*(torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.2)
                           for s in ((d, H, hd), (d, Kv, hd), (d, Kv, hd), (H, hd, d))))
    x = torch.from_numpy(rng.standard_normal((2, S, d)).astype(np.float32))
    pos = torch.arange(S)
    outs = [tattn.attention_forward(p, x, positions=pos, rope_theta=10000.0, window=win,
                                    kv_chunk=kv_chunk, backend=be) for be in ("jnp", "pallas")]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="backend"):
        tattn.attention_forward(p, x, positions=pos, rope_theta=10000.0, backend="flash")


@pytest.mark.parametrize("causal,win", [(True, None), (True, 3), (False, None)])
@pytest.mark.parametrize("kv_chunk", [16, 4, 3])
def test_blockwise_attention_ragged_chunks_match_the_oracle(causal, win, kv_chunk):
    """The port's blockwise attention equals the reference's oracle for
    every kv_chunk, ragged last chunk included (f32, within 2e-5)."""
    q, k, v = _inputs(1, 10, 4, 2, 8, seed=kv_chunk)
    pos = np.arange(10)
    got = tattn.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    q_positions=torch.from_numpy(pos),
                                    kv_positions=torch.from_numpy(pos), causal=causal,
                                    window=win, kv_chunk=kv_chunk)
    want = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                   window=win)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    if (causal, win, kv_chunk) == (True, None, 16):
        # one chunk: the reference's blockwise attention agrees too
        jwant = jattn.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                          q_positions=jnp.asarray(pos),
                                          kv_positions=jnp.asarray(pos), kv_chunk=kv_chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=2e-5)


def test_reference_blockwise_attends_to_its_padding():
    """A fault of the reference that the port does not copy (ROADMAP,
    faults): with a causal mask, no window and Skv not a multiple of
    kv_chunk, the reference pads the keys with zeros at position -1e9,
    which its causal test (q - k >= 0) lets through, so every row's
    softmax also weighs the padding. The port's blockwise attention equals
    the oracle on the same input (the test above)."""
    q, k, v = _inputs(1, 10, 2, 2, 8, seed=0)
    pos = jnp.arange(10)
    out = jattn.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)), q_positions=pos,
                                    kv_positions=pos, causal=True, kv_chunk=4)
    oracle = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    assert np.abs(np.asarray(out) - oracle.numpy()).max() > 0.1


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 1, 8, seed=1))
    torch.testing.assert_close(ops.flash_attention(q, k, v, window=5),
                               ref.flash_attention_ref(q, k, v, window=5), rtol=0, atol=0)
    # a meta tensor runs the kernel op's fake (the shape, nothing launched);
    # any other device is refused
    assert ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta")).shape == q.shape
    with pytest.raises(ValueError, match="not supported"):
        ops.flash_attention(SimpleNamespace(device=torch.device("xpu")), k, v)
