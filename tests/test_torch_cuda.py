"""The port's CUDA kernels and its session on the card (marked `cuda`;
each test skips where torch finds no CUDA device).

This file imports no jax, so it also runs on a machine with a card and
without the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: the kernels use the plain versions' op order with
round-to-nearest intrinsics, so only log1pf could differ (1e-6); the
squared norm sums in another order (rtol 1e-5); the bank codec kernels
(absmax, encode, decode), tree_delta and scale_noise equal their plain
versions bit for bit. Inside the port, `spec.pack` of a pytree session
equals the flat engine's reference mode bit for bit on the card too. The
session on the card and on the CPU agree to 1e-5 (cuBLAS and
the CPU BLAS sum in other orders; the tree's nodes are Laplace draws,
log1pf against log1p); integer results are exact. On an int8 bank the two
may differ by one quantization step where such a difference flipped a
stochastic rounding decision.
"""
import pytest
import torch

from repro_torch import random as trandom
from repro_torch.configs import DENSE_124M
from repro_torch.federation import (DataOwner, Federation, FederationConfig, PrivatizerConfig,
                                    QuantBank)
from repro_torch.tree_util import tree_flatten
from repro_torch.kernels.bank_codec import kernel as bkernel
from repro_torch.kernels.bank_codec import ops as bops
from repro_torch.kernels.bank_codec import ref as bref
from repro_torch.kernels.dp_clip_noise import kernel as tkernel
from repro_torch.kernels.dp_clip_noise import ops as tops
from repro_torch.kernels.dp_clip_noise import ref as tref
from repro_torch.kernels.tree_noise import kernel as nkernel
from repro_torch.kernels.tree_noise import ops as nops
from repro_torch.kernels.tree_noise import ref as nref
from repro_torch.models import LM

ROUND = dict(sigma=1e-2, lr_own=0.3, lr_l=0.2, n_owners=4, theta_max=1.0)


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 4099, 3 * 1024 * 1024 + 77])
def test_kernels_match_plain_versions(p):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(p)
    tb = torch.randn(p, device=dev, generator=gen)
    acc = torch.randn(p, device=dev, generator=gen)
    key = trandom.PRNGKey(5, device=dev)
    s = [torch.tensor(v, device=dev) for v in (0.5, 0.9, 0.125)]
    before = dict(tkernel.launches)
    new_l, new_i = tops.dp_round_flat(tb, acc, key, *s, **ROUND)
    ref_l, ref_i = tref.dp_round_ref(tb, acc, trandom.bits(key, (p,)), *s, **ROUND)
    torch.testing.assert_close(new_l, ref_l, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(new_i, ref_i, rtol=1e-6, atol=1e-6)
    a, b = tops.fused_sqnorm(tb), tops.fused_sqnorm(tb)
    assert torch.equal(a, b)                                  # deterministic
    torch.testing.assert_close(a, tref.sqnorm_ref(tb), rtol=1e-5, atol=0.0)
    assert tkernel.launches == {"dp_round": before["dp_round"] + 1,
                                "scale_noise": before["scale_noise"],
                                "sqnorm": before["sqnorm"] + 2}


@pytest.mark.cuda
def test_sqnorm_of_an_unaligned_view():
    dev = _device()
    g = torch.randn(10_001, device=dev)[1:]                   # 4-byte offset
    torch.testing.assert_close(tops.fused_sqnorm(g), tref.sqnorm_ref(g), rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 4099, 3 * 1024 * 1024 + 77])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_bank_codec_kernels_match_plain_versions(fmt, p):
    dev = _device()
    x = torch.randn(p, device=dev, generator=torch.Generator(device=dev).manual_seed(p)) * 0.1
    key = trandom.PRNGKey(6, device=dev)
    before = dict(bkernel.launches)
    for det in (False, True):
        codes, scales, err = bops.encode_row(x, key, fmt, deterministic=det)
        ref_codes, ref_scales, ref_err = bref.encode_row_ref(x, key, fmt, deterministic=det)
        assert torch.equal(codes, ref_codes) and torch.equal(scales, ref_scales)
        assert torch.equal(err, ref_err)
        assert torch.equal(bops.decode_row(codes, scales, fmt),
                           bref.decode_row_ref(codes, scales, fmt))
    assert bkernel.launches == {"absmax": before["absmax"] + 2,
                                "encode": before["encode"] + 2,
                                "decode": before["decode"] + 2}


@pytest.mark.cuda
def test_bank_codec_edges_on_the_card():
    dev = _device()
    pats = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    out = bops.decode_row(pats.to(dev), torch.ones(1, device=dev), "fp8").cpu()
    assert torch.equal(out, bref.fp8_to_f32(pats))
    x = torch.randn(10_001, device=dev)
    x[5] = float("nan")
    assert bool(torch.isnan(bops.row_scale(x, "int8")).all())
    tail = x[6:]                           # past the NaN, and not 16-byte aligned
    assert torch.equal(bops.row_scale(tail, "fp8"), bref.row_scales_ref(tail.reshape(1, -1),
                                                                        448.0))
    with pytest.raises(NotImplementedError):
        bops.encode_row(x, None, "int8", block_elems=1000, deterministic=True)
    with pytest.raises(NotImplementedError):
        bops.decode_row(torch.zeros(8, dtype=torch.int8, device=dev),
                        torch.ones(2, device=dev), "int8", block_elems=4)


@pytest.mark.cuda
@pytest.mark.parametrize("bank_dtype", [None, "int8"])
def test_session_on_the_card_matches_the_cpu(bank_dtype):
    dev = _device()
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=2)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (6, 4, 16), generator=gen, dtype=torch.int32)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    out = []
    for device in (dev, torch.device("cpu")):
        fed = Federation([DataOwner(n=100, epsilon=1.0, xi=1.0)] * 3,
                         FederationConfig.from_target_lr(0.05, n_owners=3, horizon=2,
                                                         sigma=1e-2), device=device)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True, bank_dtype=bank_dtype,
                      privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2,
                                                  fused_kernel=True))
        state, ms = fed.run_rounds(fed.init_state(params), batches,
                                   key=trandom.PRNGKey(3, device=dev))
        bank = state.bank.decode_rows() if isinstance(state.bank, QuantBank) else state.bank
        step = float(state.bank.scales.max()) if isinstance(state.bank, QuantBank) else 0.0
        out.append((ms["refused"].cpu(), fed.reconcile(state), bank.cpu(), step))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    torch.testing.assert_close(out[0][2], out[1][2], rtol=1e-4, atol=1e-5 + out[1][3])


@pytest.mark.cuda
@pytest.mark.parametrize("p,offset", [(1, 0), (4099, 0), (4096, 1), (3 * 1024 * 1024 + 76, 0)])
@pytest.mark.parametrize("depth", [1, 4])
def test_tree_delta_matches_plain_version(depth, p, offset):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(p + depth)
    n_owners = 3
    # offset 1: the node tensor starts 4 bytes into its storage (no float4)
    base = torch.randn(n_owners * depth * p + offset, device=dev, generator=gen)
    nodes = base[offset:].view(n_owners, depth, p)
    owner = torch.tensor([1], device=dev)
    key = trandom.PRNGKey(8, device=dev)
    ns = torch.tensor([0.3], device=dev)
    bits = trandom.bits(key, (p,))
    before = dict(nkernel.launches)
    def copy():
        buf = torch.empty(nodes.numel() + offset, device=dev)
        return buf[offset:].view(nodes.shape).copy_(nodes)

    for count in range((1 << depth) + 1):
        counts = torch.tensor([2, count, 0], dtype=torch.int32, device=dev)
        for grant in (None, torch.tensor(1, dtype=torch.int32, device=dev),
                      torch.tensor(0, dtype=torch.int32, device=dev)):
            out, plain = copy(), copy()
            delta = nops.tree_delta_(out, counts, owner, key, ns, grant)
            ref_delta = nref.tree_delta_inplace_ref(plain, counts, owner, bits, ns, grant)
            assert torch.equal(delta, ref_delta) and torch.equal(out, plain), (count, grant)
    assert nkernel.launches["tree_delta"] == before["tree_delta"] + 3 * ((1 << depth) + 1)
    row_delta, row = nops.tree_delta_row(nodes[1], 1, key, ns)
    want_delta, want_row = nref.tree_delta_ref(nodes[1], bits, 1, ns)
    assert torch.equal(row_delta, want_delta) and torch.equal(row, want_row)


@pytest.mark.cuda
@pytest.mark.parametrize("bank_dtype", [None, "int8"])
def test_tree_session_on_the_card_matches_the_cpu(bank_dtype):
    dev = _device()
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=2)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (10, 4, 16), generator=gen, dtype=torch.int32)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    out = []
    for device in (dev, torch.device("cpu")):
        fed = Federation([DataOwner(n=100, epsilon=1.0, xi=1.0)] * 3,
                         FederationConfig.from_target_lr(0.05, n_owners=3, horizon=8,
                                                         sigma=1e-2),
                         mechanism="tree", tree_depth=2, device=device)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True, bank_dtype=bank_dtype,
                      privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2,
                                                  fused_kernel=True))
        before = nkernel.launches["tree_delta"]
        state, ms = fed.run_rounds(fed.init_state(params), batches,
                                   key=trandom.PRNGKey(4, device=dev))
        if device.type == "cuda":
            assert nkernel.launches["tree_delta"] == before + 10
        bank = state.bank.decode_rows() if isinstance(state.bank, QuantBank) else state.bank
        step = float(state.bank.scales.max()) if isinstance(state.bank, QuantBank) else 0.0
        out.append((ms["refused"].cpu(), fed.reconcile(state), state.tree.counts.cpu(),
                    state.tree.nodes.cpu(), bank.cpu(), step))
    assert bool(out[0][0].any())                               # capacity 3 bites
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    assert torch.equal(out[0][2], out[1][2])
    torch.testing.assert_close(out[0][3], out[1][3], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out[0][4], out[1][4], rtol=1e-4, atol=1e-5 + out[1][5])


@pytest.mark.cuda
def test_default_device_is_cuda():
    _device()
    fed = Federation([DataOwner(n=10, epsilon=1.0, xi=1.0)], FederationConfig(horizon=3))
    assert fed.device.type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert trandom.PRNGKey(0).device.type == "cuda"


@pytest.mark.cuda
def test_init_gives_the_same_weights_on_every_device():
    _device()
    lm = LM(DENSE_124M.reduced())
    on_card, on_cpu = lm.init(seed=4), lm.init(seed=4, device="cpu")
    assert on_card["embed"].device.type == "cuda"
    assert torch.equal(on_card["embed"].cpu(), on_cpu["embed"])
    assert torch.equal(on_card["blocks"]["attn"].wq.cpu(), on_cpu["blocks"]["attn"].wq)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((768,), 0), ((1,), 0), ((4099,), 0), ((4096,), 1),
                                          ((3, 1000), 3), ((12, 2048, 77), 0)])
def test_scale_noise_matches_plain_version(shape, offset):
    dev = _device()
    n = 1
    for d in shape:
        n *= d
    # offset > 0: the leaf starts 4 * offset bytes into its storage (no float4)
    base = torch.randn(n + offset, device=dev, generator=torch.Generator(device=dev).manual_seed(n))
    g = base[offset:].view(shape)
    key = trandom.PRNGKey(n + 7, device=dev)
    cs, ns = torch.tensor([0.625], device=dev), torch.tensor(0.3, device=dev)
    before = tkernel.launches["scale_noise"]
    out = tops.scale_noise(g, key, cs, ns)
    plain = tref.scale_noise_ref(g, trandom.bits(key, shape), cs.reshape(()), ns)
    assert out.shape == g.shape and torch.equal(out, plain)
    assert torch.equal(tops.scale_noise(g, key, cs, ns), out)
    assert tkernel.launches["scale_noise"] == before + 2


@pytest.mark.cuda
def test_tree_entry_points_on_the_card():
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(3)
    tree = {"a": torch.randn(768, device=dev, generator=gen),
            "b": {"c": torch.randn(3, 1001, device=dev, generator=gen)},
            "d": torch.randn(5, device=dev, generator=gen)}
    key = trandom.PRNGKey(4, device=dev)
    before = dict(tkernel.launches)
    out = tops.dp_privatize_tree(tree, key, 0.5, 0.2)
    leaves = tree_flatten(tree)[0]
    # the sqnorm kernel is deterministic, so the clip factor is rebuilt exactly
    norm = torch.sqrt(tops.fused_sqnorm_tree(tree))
    torch.testing.assert_close(norm, torch.sqrt(sum(tref.sqnorm_ref(x) for x in leaves)),
                               rtol=1e-5, atol=0.0)
    clip = torch.clamp(torch.full_like(norm, 0.5) / torch.clamp(norm, min=1e-12), max=1.0)
    assert float(clip) < 1.0
    for leaf, k, o in zip(leaves, trandom.split(key, len(leaves)), tree_flatten(out)[0]):
        assert torch.equal(o, tref.scale_noise_ref(leaf, trandom.bits(k, leaf.shape), clip, 0.2))
    got = {k: tkernel.launches[k] - before[k] for k in before}
    # dp_privatize_tree: 3 sqnorm + 3 scale_noise; then 3 sqnorm for norm
    assert got == {"dp_round": 0, "scale_noise": 3, "sqnorm": 6}


def _pytree_session(device, params, lm, form, pack_params=False):
    fused, mech = {"fused": (True, {}), "unfused": (False, {}),
                   "tree": (False, dict(mechanism="tree", tree_depth=2))}[form]
    fed = Federation([DataOwner(n=100, epsilon=1.0, xi=1.0)] * 3,
                     FederationConfig.from_target_lr(0.05, n_owners=3,
                                                     horizon=8 if mech else 2, sigma=1e-2),
                     device=device, **mech)
    fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=pack_params,
                  privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2, fused_kernel=fused))
    return fed, fed.init_state(params)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fused", "unfused", "tree"])
def test_pytree_session_on_the_card_matches_the_cpu(form):
    dev = _device()
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=2)
    toks = torch.randint(0, cfg.vocab, (8, 4, 16), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    out = []
    for device in (dev, torch.device("cpu")):
        fed, state = _pytree_session(device, params, lm, form)
        before = dict(tkernel.launches)
        # owner 0 five times: past horizon 2 and capacity 3
        state, ms = fed.run_rounds(state, batches, [0, 1, 0, 0, 2, 0, 1, 0],
                                   key=trandom.PRNGKey(5, device=dev))
        got = {k: tkernel.launches[k] - before[k] for k in before}
        if device.type == "cuda":
            n_leaves = len(tree_flatten(state.theta_L)[0])
            fused = form == "fused"
            assert got == {"dp_round": 0, "scale_noise": 8 * n_leaves * fused,
                           "sqnorm": 8 * 2 * n_leaves * fused}
        tree = () if state.tree is None else (state.tree.counts, state.tree.nodes)
        out.append((ms["refused"].cpu(), fed.reconcile(state),
                    [t.cpu() for t in tree_flatten((state.theta_L, state.bank, tree))[0]]))
    assert bool(out[0][0].any())
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]
    for a, b in zip(out[0][2], out[1][2]):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_pack_of_pytree_equals_flat_reference_mode_on_the_card():
    dev = _device()
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=3)
    toks = torch.randint(0, cfg.vocab, (8, 4, 16), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    out = []
    for pack in (False, True):
        fed, state = _pytree_session(dev, params, lm, "tree", pack_params=pack)
        state, ms = fed.run_rounds(state, batches, [2, 2, 0, 2, 1, 2, 0, 1],
                                   key=trandom.PRNGKey(6, device=dev))
        out.append((state, ms["refused"], fed.reconcile(state)))
    (p_state, p_ref, p_led), (f_state, f_ref, f_led) = out
    spec = f_state.theta_L.spec

    def flat(tree, lead):
        leaves = tree_flatten(tree)[0]
        return torch.cat([leaf.reshape(leaf.shape[:lead] + (-1,)) for leaf in leaves], dim=lead)

    assert bool(p_ref.any()) and torch.equal(p_ref, f_ref) and p_led == f_led
    assert torch.equal(spec.pack(p_state.theta_L), f_state.theta_L.buf)
    assert torch.equal(flat(p_state.bank, 1), f_state.bank)
    assert torch.equal(flat(p_state.tree.nodes, 2), f_state.tree.nodes)
    assert torch.equal(p_state.tree.counts, f_state.tree.counts)
