"""The yardstick's arithmetic: each kernel's bound against PERF.md's kernel
table (rows 1, 9, 10), and the analytic training FLOPs against
`repro_torch.analysis.op_cost`'s count of the port's loss and gradient on
the CPU at a reduced size (remat off)."""
import dataclasses

import pytest
import torch

from bench.reference import model as RM
from bench.roofline import bound_s
from bench.roofline import flops as F
from bench.roofline import kernels as K


def test_dp_round_bound_is_perf_row_1():
    assert round(bound_s(0, K.dp_round_bytes(152_783_616)) * 1e3, 3) == 0.730
    assert K.dp_round_bytes(10, 3) == 3 * K.dp_round_bytes(10)


@pytest.mark.parametrize("shape, gflop, ops_ms, bytes_ms", [
    ((2, 4096, 80, 64, 64, 256), 26.93, 0.402, 0.116),
])
def test_ssd_forward_bound_is_perf_row_9(shape, gflop, ops_ms, bytes_ms):
    assert round(K.ssd_fwd_ops(*shape) / 1e9, 2) == gflop
    assert round(bound_s(K.ssd_fwd_ops(*shape), 0) * 1e3, 3) == ops_ms
    assert round(bound_s(0, K.ssd_fwd_bytes(*shape)) * 1e3, 3) == bytes_ms


@pytest.mark.parametrize("shape, gflop, ops_ms, bytes_ms", [
    ((2, 1024, 80, 64, 64, 256), 16.16, 0.241, 0.067),
])
def test_ssd_backward_bound_is_perf_row_10(shape, gflop, ops_ms, bytes_ms):
    assert round(K.ssd_bwd_ops(*shape) / 1e9, 2) == gflop
    assert round(bound_s(K.ssd_bwd_ops(*shape), 0) * 1e3, 3) == ops_ms
    assert round(bound_s(0, K.ssd_bwd_bytes(*shape)) * 1e3, 3) == bytes_ms


def _counted(cfg, batch, seq):
    from repro_torch.analysis.op_cost import OpCost
    from repro_torch.models import LM
    from repro_torch.tree_util import tree_flatten
    lm = LM(cfg, remat=False)
    params = lm.init(seed=0, device="cpu")
    leaves = [p.requires_grad_() for p in tree_flatten(params)[0]]
    toks = torch.zeros((batch, seq), dtype=torch.int64)
    with OpCost() as oc:
        lm.loss(params, {"tokens": toks, "labels": toks})[0].backward()
    assert leaves
    return oc.summary()["flops"]


def test_dense_flops_match_the_op_counter():
    """The port's plain attention multiplies the whole S x S square: the
    counter's FLOPs are the analytic count with the causal half replaced
    by the square."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config("qwen1.5-110b").reduced(), tie_embeddings=True)
    ms = RM.ModelSpec.from_config(dataclasses.asdict(cfg))
    B, S = 2, 48
    square = cfg.n_layers * B * ms.n_heads * 2 * 2 * ms.head_dim * S * S
    want = F.train_flops(ms, B, S) - 3 * F.attention_flops(ms, B, S) + 3 * square
    assert _counted(cfg, B, S) == want


def test_hybrid_flops_match_the_op_counter():
    """The hybrid's weight products as analytic; its shared attention as
    run (the whole S x S square); its SSD as the plain scan runs it on the
    CPU: four products a chunk forward (q k^T and its product with v over
    the whole Q x Q block, the carried state's read and update), two
    gradients each backward, but one for the first chunk's read of the zero
    state and none for the last chunk's unused state update."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("zamba2-2.7b").reduced()
    ms = RM.ModelSpec.from_config(dataclasses.asdict(cfg))
    B, S = 2, 64
    Q, H, N, P = ms.chunk, ms.ssm_heads, ms.d_state, ms.ssm_head_dim
    nc = S // Q
    qk, y_in, y_st, upd = (2 * B * Q * Q * H * N, 2 * B * Q * Q * H * P, 2 * B * Q * H * N * P,
                           2 * B * Q * H * N * P)
    scan = sum(3 * (qk + y_in) + (2 if c == 0 else 3) * y_st + (1 if c == nc - 1 else 3) * upd
               for c in range(nc))
    square = (cfg.n_layers // cfg.attn_every) * B * ms.n_heads * 2 * 2 * ms.head_dim * S * S
    want = 3 * F.linear_flops(ms, B * S) + 3 * square + cfg.n_layers * scan
    assert _counted(cfg, B, S) == want
