"""Plain PyTorch versions of the dp_clip_noise kernels.

The counterpart of ``repro/kernels/dp_clip_noise/ref.py``, op for op. The
wrappers in ``ops.py`` run these on CPU tensors (the CPU tests), and the
chip smoke script holds each CUDA kernel against them on the card; nothing
on the main path with a card calls them.
"""
from __future__ import annotations

import torch


def laplace_from_bits_ref(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> standard Laplace draws by inverse CDF on the top 24
    bits. torch.sign has jnp.sign's semantics: sign(0) = 0."""
    u01 = (bits.to(torch.int64) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    v = u01 - 0.5
    return -torch.sign(v) * torch.log1p(
        -2.0 * torch.abs(torch.clamp(v, -0.4999999, 0.4999999)))


def scale_noise_ref(g: torch.Tensor, bits: torch.Tensor, clip_scale,
                    noise_scale) -> torch.Tensor:
    """g * clip_scale + noise_scale * Laplace(bits) in f32, cast back to
    g's dtype (the scale-and-noise pass of eq. 4). A rank's block of a
    leaf takes the bits of that block (`random.bits_block`)."""
    lap = laplace_from_bits_ref(bits)
    return (g.to(torch.float32) * clip_scale + noise_scale * lap).to(g.dtype)


def sqnorm_ref(g: torch.Tensor) -> torch.Tensor:
    gf = g.to(torch.float32)
    return torch.sum(gf * gf)


def sqnorm_rows_ref(g: torch.Tensor) -> torch.Tensor:
    """(rows, P) -> (rows,): sqnorm_ref of each row, one after another, so
    row m is bit for bit sqnorm_ref(g[m])."""
    return torch.stack([sqnorm_ref(row) for row in g])


def dp_round_ref(tb: torch.Tensor, acc: torch.Tensor, bits: torch.Tensor,
                 gain, noise_scale, w, *, sigma: float, lr_own: float,
                 lr_l: float, n_owners: int, theta_max: float):
    """The whole inertia round past the gradient -> (new_L, new_i).

        q     = acc * gain + noise_scale * Laplace(bits)      (eq. 4)
        g_reg = sigma * tb                                    (grad of g)
        new_i = Pi[ tb - lr_own * (g_reg/(2N) + w * q) ]      (eq. 5)
        new_L = Pi[ tb - lr_L * g_reg ]                       (eq. 7)
    """
    tbf = tb.to(torch.float32)
    q = acc.to(torch.float32) * gain + noise_scale * laplace_from_bits_ref(bits)
    g_reg = sigma * tbf
    new_i = torch.clamp(tbf - lr_own * (g_reg * (1.0 / (2 * n_owners)) + w * q),
                        -theta_max, theta_max)
    new_l = torch.clamp(tbf - lr_l * g_reg, -theta_max, theta_max)
    return new_l, new_i


def dp_round_rows_ref(tb: torch.Tensor, acc: torch.Tensor, bits: torch.Tensor,
                      gain: torch.Tensor, noise_scale: torch.Tensor, w: torch.Tensor,
                      **kw):
    """dp_round_ref over g members -> (new_L, new_i), each (g, P): row m of
    tb, acc and bits (g, P) with the m-th of gain, noise_scale and w ((g,)),
    one member after another, so row m is bit for bit dp_round_ref on it."""
    outs = [dp_round_ref(tb[m], acc[m], bits[m], gain[m:m + 1], noise_scale[m:m + 1],
                         w[m:m + 1], **kw) for m in range(tb.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
