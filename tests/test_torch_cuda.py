"""The port's CUDA kernels and its session on the card (marked `cuda`;
each test skips where torch finds no CUDA device).

This file imports no jax, so it also runs on a machine with a card and
without the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Per-example clipping on the fused flat engine runs on the card with one
sqnorm row-axis launch a round (a group under the grouped driver), agrees
with the CPU within 1e-4 (an f16 bank one f16 step; a model cast to bf16
1e-3, its loss in bf16 on both sides), and its step loop equals run_rounds
bit for bit.

Tolerances: the kernels use the plain versions' op order with
round-to-nearest intrinsics, so only log1pf could differ (1e-6); the
squared norm sums in another order (rtol 1e-5); the bank codec kernels
(absmax, encode, decode), tree_delta and scale_noise equal their plain
versions bit for bit; their batched forms (the grouped driver's member
axis) equal g single launches bit for bit. Inside the port, `spec.pack`
of a pytree session equals the flat engine's reference mode bit for bit
on the card too, and a grouped dispatch's ledger and noise tree equal the
sequential dispatch's, as do a fault-armed dispatch's counters. The
session on the card and on the CPU agree to 1e-5 (cuBLAS and
the CPU BLAS sum in other orders; the tree's nodes are Laplace draws,
log1pf against log1p); integer results are exact. On an int8 bank the two
may differ by one quantization step where such a difference flipped a
stochastic rounding decision.

Flash attention sums in other orders than its plain version: f32 within
2e-5 (outputs about 1). The SSD kernels add each output's f32 products (up
to a chunk's 256 rows times a depth of up to 128) in another order than the
plain version's einsums, and dld is a reverse cumsum of such sums over the
chunk (cum itself is equal bit for bit): y and the final state are held
within 1e-4 plus 5e-5 of their largest value. bf16 outputs are also allowed
one bf16 step (relative 2^-7), since both sides round their f32 results to
bf16. Two launches give the same bits. The reduced zamba2 on the card
agrees with the CPU within 1e-4 (two layers of f32 matmuls in other
orders). The SSD backward kernel, and the scan's gradient through it, are
held to the scan's bound against their plain versions; the reduced
zamba2's loss gradient on the card to 1e-3 of each leaf's largest value
against the CPU's.
"""
import pytest
import torch

from repro_torch import random as trandom
from repro_torch.configs import DENSE_124M
from repro_torch.federation import (DataOwner, Federation, FederationConfig, PrivatizerConfig,
                                    QuantBank, partition_conflict_free)
from repro_torch.tree_util import tree_flatten
from repro_torch.kernels.bank_codec import kernel as bkernel
from repro_torch.kernels.bank_codec import ops as bops
from repro_torch.kernels.bank_codec import ref as bref
from repro_torch.kernels.dp_clip_noise import kernel as tkernel
from repro_torch.kernels.dp_clip_noise import ops as tops
from repro_torch.kernels.dp_clip_noise import ref as tref
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.ssm_scan import kernel as skernel
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.kernels.ssm_scan import ref as sref
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
@pytest.mark.parametrize("p", [4099, 3 * 1024 * 1024 + 76])
@pytest.mark.parametrize("g", [1, 3, 8])
def test_batched_kernels_equal_single_launches(g, p):
    # the member axis of the grouped driver: one launch for g rows, row m
    # bit for bit the single launch on row m (sqnorm on the same view, so
    # the same float4 decision) and the plain versions' row loop
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(g * p)
    tb = torch.randn(g, p, device=dev, generator=gen)
    acc = torch.randn(g, p, device=dev, generator=gen)
    keys = trandom.split(trandom.PRNGKey(g, device=dev), g)
    gain, ns, w = (torch.rand(g, device=dev, generator=gen) for _ in range(3))
    before = {**tkernel.launches, **nkernel.launches}
    new_l, new_i = tops.dp_round_rows(tb, acc, keys, gain, ns, w, **ROUND)
    sq = tops.fused_sqnorm_rows(acc)
    nodes = torch.randn(10, 4, p, device=dev, generator=gen)
    counts = torch.tensor([0, 1, 3, 2, 5, 6, 0, 7, 2, 3], dtype=torch.int32, device=dev)
    owners = torch.randperm(10, device=dev, generator=gen)[:g]
    grant = (torch.arange(g, device=dev) % 3 != 2).to(torch.int32)
    batched = nodes.clone()
    delta = nops.tree_delta_rows_(batched, counts, owners, keys, ns, grant)
    after = {**tkernel.launches, **nkernel.launches}
    assert {k: after[k] - before[k] for k in ("dp_round", "sqnorm", "tree_delta")} == {
        "dp_round": 1, "sqnorm": 1, "tree_delta": 1}
    single = nodes.clone()
    for m in range(g):
        one_l, one_i = tops.dp_round_flat(tb[m], acc[m], keys[m], gain[m:m + 1], ns[m:m + 1],
                                          w[m:m + 1], **ROUND)
        assert torch.equal(new_l[m], one_l) and torch.equal(new_i[m], one_i), m
        assert torch.equal(sq[m], tops.fused_sqnorm(acc[m])), m
        one = nops.tree_delta_(single, counts, owners[m:m + 1], keys[m], ns[m:m + 1],
                               grant[m:m + 1])
        assert torch.equal(delta[m], one), m
    assert torch.equal(batched, single)
    bits = trandom.bits(keys, (p,))
    ref_l, ref_i = tref.dp_round_rows_ref(tb, acc, bits, gain, ns, w, **ROUND)
    assert torch.equal(new_l, ref_l) and torch.equal(new_i, ref_i)
    torch.testing.assert_close(sq, tref.sqnorm_rows_ref(acc), rtol=1e-5, atol=0.0)
    plain = nodes.clone()
    ref_delta = nref.tree_delta_rows_inplace_ref(plain, counts, owners, bits, ns, grant)
    assert torch.equal(delta, ref_delta) and torch.equal(batched, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["f32", "tree"])
def test_grouped_session_on_the_card(form):
    # the grouped dispatch on the card: one dp_round (tree: one tree_delta)
    # and G sqnorm launches per group; the ledger and the tree equal the
    # sequential dispatch's on the card (the nodes bit for bit), and theta_L
    # and the bank agree with the grouped dispatch on the CPU
    dev = _device()
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=2)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (12, 4, 16), generator=gen, dtype=torch.int32)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    seq = [0, 1, 2, 3, 1, 0, 3, 2, 2, 2, 1, 0]              # groups of 4, 4, 1 and 3
    n_groups = len(partition_conflict_free(seq))
    tree = form == "tree"
    mech = dict(mechanism="tree", tree_depth=2) if tree else {}
    out = {}
    for role, device, grouped in (("card", dev, True), ("sequential", dev, False),
                                  ("cpu", torch.device("cpu"), True)):
        fed = Federation([DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0) for i in range(4)],
                         FederationConfig.from_target_lr(0.05, n_owners=4,
                                                         horizon=8 if tree else 2,
                                                         sigma=1e-2),
                         device=device, **mech)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True,
                      privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2,
                                                  fused_kernel=True))
        before = {**tkernel.launches, **nkernel.launches}
        state, ms = fed.run_rounds(fed.init_state(params), batches, seq,
                                   key=trandom.PRNGKey(5, device=device),
                                   owner_parallel=grouped, max_group=None)
        after = {**tkernel.launches, **nkernel.launches}
        if role == "card":
            rounds = n_groups
            assert {k: after[k] - before[k] for k in ("dp_round", "sqnorm", "tree_delta")} == {
                "dp_round": 0 if tree else rounds, "sqnorm": 2 * rounds,
                "tree_delta": rounds if tree else 0}
        out[role] = dict(
            refused=ms["refused"].cpu(), owner=ms["owner"].cpu(), ledger=fed.reconcile(state),
            theta=state.theta_L.buf.cpu(), bank=state.bank.cpu(),
            counts=state.tree.counts.cpu() if tree else None,
            nodes=state.tree.nodes.cpu() if tree else None)
    card, seq_run, cpu = out["card"], out["sequential"], out["cpu"]
    assert bool(card["refused"].any())
    for other in (seq_run, cpu):
        assert torch.equal(card["refused"], other["refused"])
        assert torch.equal(card["owner"], other["owner"])
        assert card["ledger"] == other["ledger"]
    if tree:
        assert torch.equal(card["counts"], seq_run["counts"])
        assert torch.equal(card["counts"], cpu["counts"])
        assert torch.equal(card["nodes"], seq_run["nodes"])
        torch.testing.assert_close(card["nodes"], cpu["nodes"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(card["theta"], cpu["theta"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(card["bank"], cpu["bank"], rtol=1e-4, atol=1e-5)


def _to_dtype(tree, dtype):
    from repro_torch.tree_util import tree_map
    return tree_map(lambda leaf: leaf.to(dtype), tree)


def _example_session(device, params, lm, bank_dtype=None, horizon=2):
    fed = Federation([DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0) for i in range(4)],
                     FederationConfig.from_target_lr(0.05, n_owners=4, horizon=horizon,
                                                     sigma=1e-2), device=device)
    fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True, bank_dtype=bank_dtype,
                  privatizer=PrivatizerConfig(xi=1.0, granularity="example",
                                              fused_kernel=True))
    return fed


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["sequential", "grouped"])
@pytest.mark.parametrize("form", ["f32", "f16-bank", "bf16-leaves"])
def test_example_granularity_on_the_card_matches_the_cpu(form, driver):
    # per-example clipping on the fused flat engine: one sqnorm row-axis
    # launch a round (sequential) or a group (grouped) and one dp_round
    # each; refusals, owners and the ledger equal the CPU run's, theta_L and
    # the bank agree with it (bf16 leaves: the loss in bf16 on both sides)
    dev = _device()
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=2)
    if form == "bf16-leaves":
        params = _to_dtype(params, torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (8, 4, 16), generator=gen, dtype=torch.int32)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    seq = [0, 1, 2, 3, 1, 0, 3, 2]                          # groups of 4 and 4
    grouped = driver == "grouped"
    n_calls = len(partition_conflict_free(seq)) if grouped else len(seq)
    out = {}
    for device in (dev, torch.device("cpu")):
        fed = _example_session(device, params, lm,
                               bank_dtype=torch.float16 if form == "f16-bank" else None)
        before = dict(tkernel.launches)
        state, ms = fed.run_rounds(fed.init_state(params), batches, seq,
                                   key=trandom.PRNGKey(5, device=device),
                                   owner_parallel=grouped, max_group=None)
        got = {k: tkernel.launches[k] - before[k] for k in ("dp_round", "sqnorm")}
        if device.type == "cuda":
            assert got == {"dp_round": n_calls, "sqnorm": n_calls}
            assert ([leaf.dtype for leaf in tree_flatten(fed.params_of(state))[0]]
                    == [leaf.dtype for leaf in tree_flatten(params)[0]])
        out[device.type] = (ms["refused"].cpu(), ms["owner"].cpu(), fed.reconcile(state),
                            state.theta_L.buf.cpu(), state.bank.float().cpu(),
                            ms["clip_frac"].cpu())
    card, cpu = out["cuda"], out["cpu"]
    assert torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1]) and card[2] == cpu[2]
    tol = dict(rtol=1e-3, atol=1e-4) if form == "bf16-leaves" else dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(card[3], cpu[3], **tol)
    if form == "f16-bank":
        tol = dict(rtol=2 ** -10, atol=1e-5)
    torch.testing.assert_close(card[4], cpu[4], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["f32", "bf16-leaves"])
def test_example_step_loop_equals_run_rounds_on_the_card(form):
    # the step loop equals run_rounds bit for bit on the card at example
    # granularity, refusals included (horizon 2 over 8 rounds of 4 owners)
    dev = _device()
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=3, device=dev)
    if form == "bf16-leaves":
        params = _to_dtype(params, torch.bfloat16)
    gen = torch.Generator().manual_seed(6)
    toks = torch.randint(0, cfg.vocab, (8, 4, 16), generator=gen, dtype=torch.int32)
    batches = {"tokens": toks.to(dev), "labels": torch.roll(toks, -1, dims=2).to(dev)}
    seq = [0, 0, 1, 0, 2, 1, 1, 3]
    root = trandom.PRNGKey(7, device=dev)
    keys = trandom.split(root, len(seq))
    fa = _example_session(dev, params, lm)
    sa = fa.init_state(params)
    refused = []
    for k, owner in enumerate(seq):
        sa, m = fa.step(sa, {n: v[k] for n, v in batches.items()}, owner, keys[k])
        refused.append(bool(m["refused"]))
    fb = _example_session(dev, params, lm)
    sb, ms = fb.run_rounds(fb.init_state(params), batches, seq, key=root)
    assert refused == ms["refused"].cpu().tolist() and any(refused)
    assert torch.equal(sa.theta_L.buf, sb.theta_L.buf) and torch.equal(sa.bank, sb.bank)
    assert fa.reconcile(sa) == fb.reconcile(sb)


FAULT_COLUMNS = ("spent", "refused", "dropped", "faulted", "quarantined", "timed_out",
                 "retried")


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["sequential", "grouped"])
@pytest.mark.parametrize("form", ["f32", "int8", "tree", "pytree"])
def test_fault_armed_session_on_the_card_matches_the_cpu(form, driver):
    # a FaultPlan and a LatencyPlan under FaultPolicy and StalenessPolicy
    # (decay armed) on the card and on the CPU: the seven ledger columns,
    # the fault and runtime counters, the outcome masks, the step and the
    # reconciled ledger exactly; theta_L and the bank within the session's
    # tolerances (int8: one quantization step); the stored checksums equal
    # bank_checksums on the card; launches: K dp_round or 2K tree_delta a
    # sequential dispatch, one dp_round or two tree_delta a group
    from repro_torch.federation import (FaultPlan, FaultPolicy, LatencyPlan, StalenessPolicy,
                                        bank_checksums)
    dev = _device()
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    K = 12
    toks = torch.randint(0, cfg.vocab, (K, 4, 16), generator=gen, dtype=torch.int32)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    seq = [0, 1, 2, 3, 1, 0, 3, 2, 2, 2, 1, 0]
    grouped = driver == "grouped"
    n_groups = len(partition_conflict_free(seq)) if grouped else K
    tree, pack = form == "tree", form != "pytree"
    out = []
    for device in (dev, torch.device("cpu")):
        fed = Federation([DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0) for i in range(4)],
                         FederationConfig.from_target_lr(0.05, n_owners=4, horizon=8,
                                                         sigma=1e-2),
                         fault_policy=FaultPolicy(max_faults=2, window=8),
                         staleness=StalenessPolicy(deadline=1.0, max_retries=2, backoff_cap=2,
                                                   decay=0.9),
                         device=device, **(dict(mechanism="tree", tree_depth=3) if tree else {}))
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=pack,
                      bank_dtype="int8" if form == "int8" else None,
                      privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2, fused_kernel=True))
        before = {**tkernel.launches, **nkernel.launches}
        state, ms = fed.run_rounds(fed.init_state(params), batches, seq,
                                   key=trandom.PRNGKey(6, device=device),
                                   faults=FaultPlan(drop=0.1, stale=0.1, nonfinite=0.1,
                                                    corrupt=0.1),
                                   latency=LatencyPlan(base=[0.2, 0.5, 0.7, 0.9], jitter=0.3),
                                   owner_parallel=grouped, max_group=None)
        after = {**tkernel.launches, **nkernel.launches}
        if device.type == "cuda":
            assert torch.equal(bank_checksums(state.bank), state.faults.checksum)
            if pack:
                assert {k: after[k] - before[k] for k in ("dp_round", "sqnorm", "tree_delta")} == {
                    "dp_round": 0 if tree else n_groups, "sqnorm": 2 * n_groups,
                    "tree_delta": 2 * n_groups if tree else 0}
        bank = state.bank
        out.append(dict(
            masks={k: ms[k].cpu() for k in ("owner", "refused", "dropped", "faulted",
                                            "quarantined", "timed_out", "retried")},
            counters=[getattr(state.ledger, c).cpu() for c in FAULT_COLUMNS]
            + [t.cpu() for t in state.faults[1:]] + [t.cpu() for t in state.stale]
            + [state.step.cpu()] + ([state.tree.counts.cpu()] if tree else []),
            ledger=fed.reconcile(state),
            theta=[t.cpu() for t in ([state.theta_L.buf] if pack
                                     else tree_flatten(state.theta_L)[0])],
            bank=([bank.codes.cpu(), bank.scales.cpu(), bank.residual.cpu()]
                  if isinstance(bank, QuantBank) else [t.cpu() for t in tree_flatten(bank)[0]]),
            nodes=state.tree.nodes.cpu() if tree else None))
    card, cpu = out
    for k in card["masks"]:
        assert torch.equal(card["masks"][k], cpu["masks"][k]), k
    assert all(torch.equal(a, b) for a, b in zip(card["counters"], cpu["counters"]))
    assert card["ledger"] == cpu["ledger"]
    assert bool(card["masks"]["timed_out"].any()) and bool(card["masks"]["faulted"].any())
    for a, b in zip(card["theta"], cpu["theta"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if form == "int8":
        step = float(cpu["bank"][1].max())
        assert int((card["bank"][0].int() - cpu["bank"][0].int()).abs().max()) <= 1
        torch.testing.assert_close(card["bank"][1], cpu["bank"][1], rtol=1e-6, atol=0.0)
        torch.testing.assert_close(card["bank"][2], cpu["bank"][2], rtol=0.0, atol=step)
    else:
        for a, b in zip(card["bank"], cpu["bank"]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if tree:
        torch.testing.assert_close(card["nodes"], cpu["nodes"], rtol=1e-4, atol=1e-5)


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
@pytest.mark.parametrize("shape,cuts", [((768, 3072), (2, 2)), ((12, 768, 3072), (1, 2, 2)),
                                        ((2, 8, 6, 64), (1, 2, 1, 2)), ((4099, 6), (1, 3)),
                                        ((4, 5, 6), (1, 5, 2))])
def test_block_scale_noise_tiles_the_whole_launch(shape, cuts):
    """Each rank's block of a leaf (cut evenly `cuts` ways) through the block
    scale_noise: equal to its plain version on the block's bits
    (random.bits_block), and the blocks together equal the whole-leaf
    launch bit for bit."""
    import itertools
    dev = _device()
    g = torch.randn(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(9))
    key = trandom.PRNGKey(21, device=dev)
    cs, ns = torch.tensor([0.625], device=dev), torch.tensor(0.3, device=dev)
    whole = tops.scale_noise(g, key, cs, ns)
    out = torch.empty_like(g)
    sizes = [d // c for d, c in zip(shape, cuts)]
    before = tkernel.launches["scale_noise"]
    n_blocks = 0
    for idx in itertools.product(*(range(c) for c in cuts)):
        offsets = tuple(i * n for i, n in zip(idx, sizes))
        sl = tuple(slice(o, o + n) for o, n in zip(offsets, sizes))
        block = g[sl].contiguous()
        got = tops.scale_noise(block, key, cs, ns, (shape, offsets))
        plain = tref.scale_noise_ref(block, trandom.bits_block(key, shape, offsets, sizes),
                                     cs.reshape(()), ns)
        assert torch.equal(got, plain)
        out[sl] = got
        n_blocks += 1
    assert torch.equal(out, whole)
    assert tkernel.launches["scale_noise"] == before + n_blocks


@pytest.mark.cuda
def test_fused_tree_entry_points_take_bf16_leaves():
    """A bf16 gradient tree through fused_sqnorm_tree and
    fused_scale_noise_tree on the card: each leaf upcast to f32 for the
    kernel (as the reference's _pack does), the noisy leaf cast back, equal
    to the plain versions on the upcast leaves."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(6)
    tree = {"a": torch.randn(768, device=dev, generator=gen).to(torch.bfloat16),
            "b": torch.randn(3, 1001, device=dev, generator=gen).to(torch.bfloat16)}
    leaves = tree_flatten(tree)[0]
    torch.testing.assert_close(tops.fused_sqnorm_tree(tree),
                               sum(tref.sqnorm_ref(x.float()) for x in leaves),
                               rtol=1e-5, atol=0.0)
    key = trandom.PRNGKey(8, device=dev)
    out = tree_flatten(tops.fused_scale_noise_tree(tree, key, 0.5, 0.2))[0]
    for leaf, k, o in zip(leaves, trandom.split(key, len(leaves)), out):
        assert o.dtype == torch.bfloat16
        assert torch.equal(o, tref.scale_noise_ref(leaf.float(), trandom.bits(k, leaf.shape),
                                                   0.5, 0.2).to(torch.bfloat16))


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


def _close(out, plain, scan=False):
    """The kernels' tolerances against their plain versions (see above)."""
    atol = 1e-4 + 5e-5 * float(plain.abs().max()) if scan else 2e-5
    if out.dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), plain.float(), rtol=2 ** -7, atol=atol)
    else:
        torch.testing.assert_close(out, plain, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kv,hd,win,causal", [
    (2, 128, 4, 2, 64, None, True), (1, 100, 4, 1, 32, 16, True), (2, 97, 2, 2, 80, None, False),
    (1, 200, 8, 2, 128, 64, True), (1, 70, 2, 2, 8, None, True), (1, 65, 2, 1, 96, 7, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(B, S, H, Kv, hd, win, causal, dtype):
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(S + hd)
    q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
               for shape in ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))
    before = fkernel.launches["flash_attention"]
    out = fops.flash_attention(q, k, v, causal=causal, window=win)
    again = fops.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fkernel.launches["flash_attention"] == before + 2
    assert out.dtype == dtype and out.shape == q.shape and torch.equal(out, again)
    _close(out, fref.flash_attention_ref(q, k, v, causal=causal, window=win))


@pytest.mark.cuda
def test_flash_attention_through_strides_and_unaligned_rows():
    """q, k, v as views of one packed (B, S, 3, H, hd) tensor (strided), and
    rows that start 4 bytes off a 16-byte boundary (no vector loads)."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(9)
    qkv = torch.randn((2, 90, 3, 4, 40), device=dev, generator=gen)
    q, k, v = qkv.unbind(2)
    torch.testing.assert_close(fops.flash_attention(q, k, v, window=33),
                               fref.flash_attention_ref(q, k, v, window=33), rtol=0, atol=2e-5)
    flat = torch.randn(2 * 50 * 2 * 24 + 1, device=dev, generator=gen)
    x = flat[1:].view(2, 50, 2, 24)
    torch.testing.assert_close(fops.flash_attention(x, x, x), fref.flash_attention_ref(x, x, x),
                               rtol=0, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kv,hd", [(2, 4096, 16, 8, 128), (4, 448, 16, 16, 64),
                                         (1, 4096, 48, 1, 128)],
                         ids=["internvl2-2b", "whisper-medium", "granite-20b-mqa"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_the_vlm_audio_and_mqa_prefill_shapes(B, S, H, Kv, hd, dtype):
    """The prefills of internvl2-2b (GQA, hd 128), whisper-medium's decoder
    (hd 64, its 448-token context) and granite-20b (MQA: one kv head for 48
    query heads), causal. At S 4096 each softmax sums up to 4096 terms in
    other orders than the plain version's, so f32 is held within 1e-4, as
    chip_smoke.py holds these shapes; bf16 one bf16 step more."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(H + S)
    q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
               for shape in ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))
    before = fkernel.launches["flash_attention"]
    out = fops.flash_attention(q, k, v)
    again = fops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fkernel.launches["flash_attention"] == before + 2
    assert out.dtype == dtype and out.shape == q.shape and torch.equal(out, again)
    plain = fref.flash_attention_ref(q, k, v)
    torch.testing.assert_close(out.float(), plain.float(),
                               rtol=2 ** -7 if dtype == torch.bfloat16 else 0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-medium"])
def test_reduced_vlm_and_audio_forwards_on_the_card(arch):
    """The reduced forward through the flash kernel against the plain path
    ("jnp"), both on the card, and against the CPU, within 1e-4; one flash
    launch a decoder layer and none on the plain path."""
    from repro_torch.configs import get_config
    dev = _device()
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(6)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((2, cfg.n_patches, cfg.d_model), generator=gen)
    else:
        batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=gen)
    on_card = {k: t.to(dev) for k, t in batch.items()}
    params = LM(cfg).init(seed=6)
    outs = {}
    for backend in ("pallas", "jnp"):
        before = fkernel.launches["flash_attention"]
        with torch.no_grad():
            outs[backend] = LM(cfg, attn_backend=backend).forward(params, on_card)
        assert fkernel.launches["flash_attention"] - before == (
            cfg.n_layers if backend == "pallas" else 0)
    assert tuple(outs["pallas"].shape) == (2, 40, cfg.d_model)
    torch.testing.assert_close(outs["pallas"], outs["jnp"], rtol=0, atol=1e-4)
    cpu = LM(cfg).forward(LM(cfg).init(seed=6, device="cpu"), batch)
    torch.testing.assert_close(outs["pallas"].cpu(), cpu, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_audio_decode_after_prime_cross_cache_on_the_card():
    """The reduced whisper on the card: prime_cross_cache, then decode
    against the kernel forward within 5e-3 (the reference test's bound),
    no kernel launch on the decode path; greedy serving's logits within
    1e-4 of the CPU's and its tokens equal."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import greedy_decode
    dev = _device()
    cfg = get_config("whisper-medium").reduced()
    lm = LM(cfg, attn_backend="pallas")
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=gen).to(torch.int32)
    frames = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=gen)
    params = lm.init(seed=7)
    with torch.no_grad():
        full = torch.einsum("bsd,dv->bsv",
                            lm.forward(params, {"tokens": toks.to(dev), "frames": frames.to(dev)}),
                            lm._unembed(params))
        before = dict(fkernel.launches)
        cache = lm.prime_cross_cache(params, lm.init_cache(2, 24, dtype=torch.float32),
                                     frames.to(dev))
        err = 0.0
        for t in range(24):
            lg, cache = lm.decode_step(params, cache, toks[:, t:t + 1].to(dev), t)
            err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
    assert dict(fkernel.launches) == before
    assert err < 5e-3, err
    out = []
    for d in (dev, torch.device("cpu")):
        p = lm.init(seed=7, device=d)
        with torch.no_grad():
            c = lm.prime_cross_cache(p, lm.init_cache(2, 10, dtype=torch.float32, device=d),
                                     frames.to(d))
            seqs, logits = greedy_decode(lm, p, c, toks[:, :4].to(d), 6)
        out.append((seqs.cpu(), logits.cpu()))
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=1e-4)
    assert torch.equal(out[0][0], out[1][0])


def _ssd_inputs(dev, B, S, H, N, P, bcast, dtype, seed, decay=1.0):
    """Mamba2-like scan inputs: ld = -decay * softplus(x) for normal x."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((B, S, H, P), device=dev, generator=gen).to(dtype)
    if bcast:       # Mamba2: B and C shared by the heads, as stride-0 views
        k, q = (torch.randn((B, S, 1, N), device=dev, generator=gen).to(dtype).expand(B, S, H, N)
                for _ in range(2))
    else:           # mLSTM: per-head keys and queries
        k, q = (torch.randn((B, S, H, N), device=dev, generator=gen).to(dtype) for _ in range(2))
    ld = -decay * torch.nn.functional.softplus(torch.randn((B, S, H), device=dev, generator=gen))
    g = torch.sigmoid(torch.randn((B, S, H), device=dev, generator=gen))
    return v, ld, k, q, g


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,N,P,Q,bcast", [
    (2, 128, 3, 16, 32, 32, False), (1, 100, 2, 8, 16, 32, True), (2, 300, 4, 64, 64, 256, True),
    (1, 256, 2, 128, 128, 64, False), (1, 10, 2, 16, 32, 32, True), (1, 130, 2, 24, 40, 100, True),
    # a chunk that is no multiple of the 64-row tile and spans two row
    # passes; a ragged last chunk shorter than one tile (90 = 80 + 10);
    # N != P at the widest variant; a chunk over 256 (the wide backward)
    (2, 500, 3, 64, 64, 200, True), (1, 90, 2, 64, 64, 80, True),
    (1, 300, 2, 128, 64, 256, False), (1, 300, 2, 64, 128, 256, True),
    (1, 700, 2, 64, 64, 512, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunked_matches_plain_version(B, S, H, N, P, Q, bcast, dtype):
    dev = _device()
    v, ld, k, q, g = _ssd_inputs(dev, B, S, H, N, P, bcast, dtype, seed=S + N)
    h0 = torch.randn((B, H, N, P), device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    before = skernel.launches["ssd_chunk_scan"]
    parts = skernel.ssd_chunk_scan_cuda(v, ld, k, q, g, min(Q, S))
    for got, want in zip(parts, sref.ssd_chunk_scan_ref(v, ld, k, q, g, min(Q, S))):
        _close(got, want, scan=True)
    for init in (None, h0):
        y, h = sops.ssd_chunked(v, ld, k, q, g, chunk=Q, h0=init)
        y2, h2 = sops.ssd_chunked(v, ld, k, q, g, chunk=Q, h0=init)
        torch.cuda.synchronize()
        assert torch.equal(y, y2) and torch.equal(h, h2)
        py, ph = sref.ssd_chunked(v, ld, k, q, g, chunk=Q, h0=init)
        assert y.dtype == dtype and h.dtype == torch.float32
        _close(y, py, scan=True)
        _close(h, ph, scan=True)
    assert skernel.launches["ssd_chunk_scan"] == before + 5


@pytest.mark.cuda
def test_kernel_entry_points_raise_under_autograd():
    """flash_attention has no backward (nor in the reference): under
    autograd on the card it raises, under no_grad it runs."""
    dev = _device()
    q = torch.randn((1, 16, 2, 8), device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        fops.flash_attention(q, q, q)
    with torch.no_grad():
        fops.flash_attention(q, q, q)


def _ssd_grads(scan, v, ld, k, q, g, h0, chunk, ry, rh):
    """d/d(v, ld, g, h0, k's and q's (B, S, 1, N) bases) of y . ry + h . rh
    for the scan `scan`, k and q broadcast over the heads."""
    B, S, H, N = k.shape
    leaves = [t.detach().clone().requires_grad_() for t in (v, ld, g, h0)]
    kb, qb = (t[:, :, :1].detach().clone().requires_grad_() for t in (k, q))
    y, h = scan(leaves[0], leaves[1], kb.expand(B, S, H, N), qb.expand(B, S, H, N), leaves[2],
                chunk=chunk, h0=leaves[3])
    loss = (y.float() * ry).sum() + (h * rh).sum()
    return torch.autograd.grad(loss, leaves + [kb, qb])


@pytest.mark.cuda
def test_ssd_chunked_gradient_flows_on_the_card():
    """Under autograd on the card ops.ssd_chunked runs the forward kernel and,
    on backward, the backward kernel (one launch each), and its gradient
    equals autograd through the plain scan within the scan's bound."""
    dev = _device()
    B, S, H, N, P, Q = 1, 40, 2, 8, 8, 16
    v, ld, k, q, g = _ssd_inputs(dev, B, S, H, N, P, True, torch.float32, seed=0)
    gen = torch.Generator(device=dev).manual_seed(2)
    h0, rh = (torch.randn((B, H, N, P), device=dev, generator=gen) for _ in range(2))
    ry = torch.randn((B, S, H, P), device=dev, generator=gen)
    before = dict(skernel.launches)
    got = _ssd_grads(sops.ssd_chunked, v, ld, k, q, g, h0, Q, ry, rh)
    assert {n: skernel.launches[n] - before[n] for n in before} == {
        "ssd_chunk_scan": 1, "ssd_chunk_scan_bwd": 1}
    for a, b in zip(got, _ssd_grads(sref.ssd_chunked, v, ld, k, q, g, h0, Q, ry, rh)):
        _close(a, b, scan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,N,P,Q,bcast", [
    (2, 128, 3, 16, 32, 32, False), (1, 100, 2, 8, 16, 32, True), (2, 300, 4, 64, 64, 256, True),
    (1, 256, 2, 128, 128, 64, False), (1, 10, 2, 16, 32, 32, True), (1, 130, 2, 24, 40, 100, True),
    # a chunk that is no multiple of the 64-row tile and spans two row
    # passes; a ragged last chunk shorter than one tile (90 = 80 + 10);
    # N != P at the widest variant; a chunk over 256 (the wide backward)
    (2, 500, 3, 64, 64, 200, True), (1, 90, 2, 64, 64, 80, True),
    (1, 300, 2, 128, 64, 256, False), (1, 300, 2, 64, 128, 256, True),
    (1, 700, 2, 64, 64, 512, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_scan_bwd_matches_plain_version(B, S, H, N, P, Q, bcast, dtype):
    """The backward kernel against ssd_chunk_scan_bwd_ref on the same inputs
    and cotangents: every output in its input's dtype (dk, dq dense), within
    the scan's bound (and one bf16 step for bf16 outputs); two launches give
    the same bits."""
    dev = _device()
    v, ld, k, q, g = _ssd_inputs(dev, B, S, H, N, P, bcast, dtype, seed=S + N + 1)
    nc = -(-S // Q)
    gen = torch.Generator(device=dev).manual_seed(3)
    cots = [torch.randn(shape, device=dev, generator=gen)
            for shape in ((B, S, H, P), (B, nc, H, N, P), (B, S, H), (B, nc, H))]
    before = skernel.launches["ssd_chunk_scan_bwd"]
    got = skernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q)
    again = skernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q)
    torch.cuda.synchronize()
    assert skernel.launches["ssd_chunk_scan_bwd"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = sref.ssd_chunk_scan_bwd_ref(*cots, v, ld, k, q, g, Q)
    for a, b, dt in zip(got, want, (dtype, torch.float32, dtype, dtype, torch.float32)):
        assert a.dtype == b.dtype == dt and a.shape == b.shape and a.is_contiguous()
        _close(a, b, scan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,N,P,Q,bcast", [(2, 600, 4, 64, 64, 256, True),
                                               (1, 300, 2, 128, 128, 256, False)])
def test_ssd_kernels_stay_finite_under_strong_decay(B, S, H, N, P, Q, bcast):
    """ld = -20 softplus(x): |cum| reaches thousands within a chunk, so a
    decay factored through exp(+cum) would overflow. Both kernels stay
    finite and within the scan's bound of their plain versions."""
    dev = _device()
    v, ld, k, q, g = _ssd_inputs(dev, B, S, H, N, P, bcast, torch.float32, seed=S + 7, decay=20.0)
    nc = -(-S // Q)
    parts = skernel.ssd_chunk_scan_cuda(v, ld, k, q, g, Q)
    for got, want in zip(parts, sref.ssd_chunk_scan_ref(v, ld, k, q, g, Q)):
        assert bool(torch.isfinite(got).all())
        _close(got, want, scan=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    cots = [torch.randn(shape, device=dev, generator=gen)
            for shape in ((B, S, H, P), (B, nc, H, N, P), (B, S, H), (B, nc, H))]
    got = skernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q)
    again = skernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, sref.ssd_chunk_scan_bwd_ref(*cots, v, ld, k, q, g, Q)):
        assert bool(torch.isfinite(a).all())
        _close(a, b, scan=True)


@pytest.mark.cuda
def test_vmap_grad_through_the_scan_function_on_the_card():
    """torch.func.vmap(torch.func.grad(...)) through SSDChunkScan on the
    card (the "example" granularity): the vmap rules fold the mapped axis
    into the batch, so each kernel launches once for all examples, and
    every example's gradient equals its own single-example gradient."""
    dev = _device()
    n, S, H, N, P, Q = 3, 40, 2, 8, 16, 16
    v, ld, k, q, g = _ssd_inputs(dev, n, S, H, N, P, True, torch.float32, seed=4)
    kb = k[:, :, :1].clone()

    def loss(v1, kb1, ld1, q1, g1):
        kk = kb1[None].expand(1, S, H, N)
        parts = sops.SSDChunkScan.apply(v1[None], ld1[None], kk, q1[None], g1[None], Q)
        y, h = sops.combine_chunks(*parts, q1[None], Q)
        return (y ** 2).sum() + h.sum()

    before = dict(skernel.launches)
    gv, gk = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(v, kb, ld, q, g)
    torch.cuda.synchronize()
    assert {m: skernel.launches[m] - before[m] for m in before} == {
        "ssd_chunk_scan": 1, "ssd_chunk_scan_bwd": 1}
    for i in range(n):
        vi, ki = v[i].clone().requires_grad_(), kb[i].clone().requires_grad_()
        a, b = torch.autograd.grad(loss(vi, ki, ld[i], q[i], g[i]), (vi, ki))
        _close(gv[i], a, scan=True)
        _close(gk[i], b, scan=True)


@pytest.mark.cuda
def test_reduced_zamba2_loss_gradient_on_the_card_matches_the_cpu():
    """The hybrid's loss gradient on the card (SSD forward and backward
    kernels, the training path's attention) against the CPU's plain scan,
    same weights and tokens: every leaf within 1e-3 of its largest
    |gradient| (f32 through two layers; the scan's own bound is 5e-5 of its
    largest value, and cuBLAS and the CPU BLAS sum in other orders). The
    model's remat is on (the default): the backward recomputes each group's
    forward, so each Mamba2 layer launches the scan twice."""
    from repro_torch.configs import get_config
    from repro_torch.tree_util import tree_flatten, tree_unflatten
    dev = _device()
    cfg = get_config("zamba2-2.7b").reduced()
    lm = LM(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 80), generator=torch.Generator().manual_seed(6))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    grads = []
    before = dict(skernel.launches)
    for device in (dev, torch.device("cpu")):
        leaves, treedef = tree_flatten(lm.init(seed=6, device=device))
        live = [x.requires_grad_(True) for x in leaves]
        on_device = {k: t.to(device) for k, t in batch.items()}
        loss = lm.loss(tree_unflatten(treedef, live), on_device)[0]
        grads.append([x.cpu() for x in torch.autograd.grad(loss, live)])
    assert {m: skernel.launches[m] - before[m] for m in before} == {
        "ssd_chunk_scan": 2 * cfg.n_layers, "ssd_chunk_scan_bwd": cfg.n_layers}
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * float(b.abs().max()) + 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_reduced_zamba2_on_the_card_matches_the_cpu(backend):
    """The hybrid forward and decode on the card against the CPU, and its
    launches: one SSD scan per Mamba2 layer, one flash attention per
    application of the shared block (backend "pallas" only)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import greedy_decode
    dev = _device()
    cfg = get_config("zamba2-2.7b").reduced()
    lm = LM(cfg, attn_backend=backend)
    params = lm.init(seed=5)
    cpu_params = lm.init(seed=5, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 80), generator=torch.Generator().manual_seed(5))
    before = (skernel.launches["ssd_chunk_scan"], fkernel.launches["flash_attention"])
    with torch.no_grad():
        x = lm.forward(params, {"tokens": toks.to(dev)})
    assert (skernel.launches["ssd_chunk_scan"] - before[0],
            fkernel.launches["flash_attention"] - before[1]) == (2, int(backend == "pallas"))
    torch.testing.assert_close(x.cpu(), lm.forward(cpu_params, {"tokens": toks}), rtol=0,
                               atol=1e-4)
    prompt = toks[:, :4].to(torch.int32)
    with torch.no_grad():
        seqs, logits = greedy_decode(lm, params, lm.init_cache(2, 10, dtype=torch.float32),
                                     prompt.to(dev), 6)
    cpu_seqs, cpu_logits = greedy_decode(
        lm, cpu_params, lm.init_cache(2, 10, dtype=torch.float32, device="cpu"), prompt, 6)
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=0, atol=1e-4)
    assert torch.equal(seqs.cpu(), cpu_seqs)


def _mlstm_inputs(dev, B, S, H, N, P, dtype, seed):
    """The mLSTM's scan inputs: per-head k and q, v with a ones column
    (the normalizer: P = N_v + 1, rows not 16-byte aligned), the log forget
    gate and the input gate."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((B, S, H, P - 1), device=dev, generator=gen)
    v = torch.cat([v, torch.ones((B, S, H, 1), device=dev)], dim=-1).to(dtype)
    k, q = (torch.randn((B, S, H, N), device=dev, generator=gen).to(dtype) for _ in range(2))
    ld = -torch.nn.functional.softplus(torch.randn((B, S, H), device=dev, generator=gen) + 3)
    g = torch.sigmoid(torch.randn((B, S, H), device=dev, generator=gen))
    return v, ld, k, q, g


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,N,P,Q", [
    (1, 300, 2, 128, 129, 256), (2, 600, 2, 384, 385, 256), (1, 70, 2, 40, 33, 70),
    (2, 200, 3, 128, 129, 64), (1, 9, 1, 512, 7, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernels_at_wide_heads_match_plain_versions(B, S, H, N, P, Q, dtype):
    """The wide-head variant (the mLSTM's N = dm / H, P = N + 1: 128 / 129
    reduced, 384 / 385 at xlstm-125m's width; any N and P up to 512): both
    kernels against their plain versions within the scan's bound, two
    launches bit-identical, one count each."""
    dev = _device()
    v, ld, k, q, g = _mlstm_inputs(dev, B, S, H, N, P, dtype, seed=N + P)
    before = dict(skernel.launches)
    parts = skernel.ssd_chunk_scan_cuda(v, ld, k, q, g, Q)
    again = skernel.ssd_chunk_scan_cuda(v, ld, k, q, g, Q)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(parts, again))
    for got, want in zip(parts, sref.ssd_chunk_scan_ref(v, ld, k, q, g, Q)):
        _close(got, want, scan=True)
    nc = -(-S // Q)
    gen = torch.Generator(device=dev).manual_seed(7)
    cots = [torch.randn(shape, device=dev, generator=gen)
            for shape in ((B, S, H, P), (B, nc, H, N, P), (B, S, H), (B, nc, H))]
    got = skernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q)
    again = skernel.ssd_chunk_scan_bwd_cuda(*cots, v, ld, k, q, g, Q)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = sref.ssd_chunk_scan_bwd_ref(*cots, v, ld, k, q, g, Q)
    for a, b, dt in zip(got, want, (dtype, torch.float32, dtype, dtype, torch.float32)):
        assert a.dtype == b.dtype == dt and a.shape == b.shape
        _close(a, b, scan=True)
    assert {n: skernel.launches[n] - before[n] for n in before} == {
        "ssd_chunk_scan": 2, "ssd_chunk_scan_bwd": 2}


@pytest.mark.cuda
def test_wide_heads_refuse_long_chunks_and_wider_heads():
    dev = _device()
    v, ld, k, q, g = _mlstm_inputs(dev, 1, 600, 1, 128, 129, torch.float32, seed=1)
    with pytest.raises(ValueError, match="chunks of at most 256"):
        skernel.ssd_chunk_scan_cuda(v, ld, k, q, g, 512)
    v, ld, k, q, g = _mlstm_inputs(dev, 1, 16, 1, 520, 8, torch.float32, seed=1)
    with pytest.raises(ValueError, match="at most 512"):
        skernel.ssd_chunk_scan_cuda(v, ld, k, q, g, 16)


@pytest.mark.cuda
def test_reduced_xlstm_on_the_card_matches_the_cpu():
    """The reduced xLSTM (mLSTM head N 128 / P 129 through the wide kernels)
    on the card against the CPU: the forward over S 300 (two chunks) within
    1e-4, the loss gradient at S 40 (the CPU parity test's length: over
    long sequences the sLSTM's recurrence makes the gradient ill-conditioned
    in f32) within 1e-3 of each leaf's largest |gradient| (one scan forward
    and backward per mLSTM layer), decode logits within 1e-4; then one
    federated dispatch of the flat fused engine (K = 3, G = 2: dp_round,
    sqnorm and the SSD kernels) on the card and on the CPU: owners,
    refusals and ledger exact, theta_L within 1e-5 + 1e-4 x."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.tree_util import tree_unflatten
    dev = _device()
    cfg = get_config("xlstm-125m").reduced()
    lm = LM(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 300), generator=torch.Generator().manual_seed(8))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    n_m = cfg.n_layers - len(cfg.xlstm.slstm_indices)
    outs, grads = [], []
    before = dict(skernel.launches)
    for device in (dev, torch.device("cpu")):
        leaves, treedef = tree_flatten(lm.init(seed=8, device=device))
        live = [x.requires_grad_(True) for x in leaves]
        on_device = {k: t.to(device) for k, t in batch.items()}
        params = tree_unflatten(treedef, live)
        with torch.no_grad():
            outs.append(lm.forward(params, on_device).cpu())
        loss = lm.loss(params, {k: t[:, :40] for k, t in on_device.items()})[0]
        grads.append([x.cpu() for x in torch.autograd.grad(loss, live)])
    assert {m: skernel.launches[m] - before[m] for m in before} == {
        "ssd_chunk_scan": 2 * n_m, "ssd_chunk_scan_bwd": n_m}
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-4)
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * float(b.abs().max()) + 1e-12)
    prompt = toks[:, :4].to(torch.int32)
    logits = [greedy_decode(lm, lm.init(seed=8, device=d),
                            lm.init_cache(2, 10, dtype=torch.float32, device=d),
                            prompt.to(d), 6)[1].cpu() for d in (dev, "cpu")]
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=1e-4)
    runs = []
    for device in (dev, torch.device("cpu")):
        fed = Federation([DataOwner(n=100, epsilon=1.0, xi=1.0) for _ in range(3)],
                         FederationConfig.from_target_lr(0.05, n_owners=3, horizon=2,
                                                         sigma=1e-2, theta_max=100.0),
                         device=device)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True,
                      privatizer=PrivatizerConfig(xi=1.0, granularity="microbatch",
                                                  n_microbatches=2, fused_kernel=True))
        t3 = torch.randint(0, cfg.vocab, (3, 4, 40), generator=torch.Generator().manual_seed(9))
        state, m = fed.run_rounds(fed.init_state(lm.init(seed=8, device=device)),
                                  {"tokens": t3.to(device),
                                   "labels": torch.roll(t3, -1, dims=2).to(device)},
                                  key=trandom.PRNGKey(4, device=device))
        fed.reconcile(state)
        runs.append((m["owner"].cpu(), m["refused"].cpu(), fed.ledger(),
                     state.theta_L.buf.cpu()))
    (o1, r1, l1, t1), (o2, r2, l2, t2) = runs
    assert torch.equal(o1, o2) and torch.equal(r1, r2) and l1 == l2
    torch.testing.assert_close(t1, t2, rtol=1e-4, atol=1e-5)


# ------------------------- the convex engine and the sync baseline -------------------------
def _convex_pair(dev, n_owners=6, n_per=1500):
    from repro_torch.data import owner_shards
    from repro_torch.federation import federate_problem
    shards = owner_shards("lending", [n_per] * n_owners, seed=1)
    return {d: federate_problem(shards, 1.0, reg=1e-5, theta_max=2.0, device=d)
            for d in (dev, torch.device("cpu"))}


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["uniform", "poisson", "availability", "replay"])
@pytest.mark.parametrize("mechanism", ["paper", "per_owner_rounds"])
def test_convex_run_on_the_card_matches_the_cpu(schedule, mechanism):
    """Owner sequences and ledgers bit for bit; theta_L, bank and psi
    within 1e-5 + 1e-4 x (f32 products in other orders, log1p within an
    ulp)."""
    from repro_torch.federation import (AvailabilityTraceSchedule, PoissonSchedule,
                                        UniformSchedule)
    dev = _device()
    windows = tuple(((0.7 * i / 6 + 0.5) % 1.0, (0.7 * i / 6 + 0.7) % 1.0) for i in range(6))
    sched = {"uniform": UniformSchedule(), "poisson": PoissonSchedule(rate=0.5),
             "availability": AvailabilityTraceSchedule(windows=windows, period=2.0),
             "replay": AvailabilityTraceSchedule(windows=windows, trace=(5, 0, 2, 2, 4))
             }[schedule]
    out, ledgers = {}, {}
    for d, (prob, owners) in _convex_pair(dev).items():
        for n_runs in (None, 5):
            fed = Federation(owners, FederationConfig(horizon=300, sigma=2e-5), schedule=sched,
                             mechanism=mechanism, cap_slack=1.0 if mechanism != "paper" else None,
                             device=d)
            out[d.type, n_runs] = fed.run(trandom.PRNGKey(3, device=d), prob, n_runs=n_runs)
            if n_runs is None:
                ledgers[d.type] = fed.ledger()
    assert ledgers["cuda"] == ledgers["cpu"]
    for n_runs in (None, 5):
        card, cpu = out["cuda", n_runs], out["cpu", n_runs]
        assert card.owners_seq.device.type == "cuda"
        assert torch.equal(card.owners_seq.cpu(), cpu.owners_seq)
        for f in ("theta_L", "theta_bank", "psi"):
            torch.testing.assert_close(getattr(card, f).cpu(), getattr(cpu, f), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.cuda
def test_run_sync_on_the_card_matches_the_cpu():
    dev = _device()
    out = {}
    for d, (prob, owners) in _convex_pair(dev).items():
        fed = Federation(owners, FederationConfig(horizon=200, sigma=2e-5), strategy="sync",
                         device=d)
        out[d.type] = fed.run_sync(trandom.PRNGKey(4, device=d), prob, lr=0.4, n_runs=3)
        assert all(r["responses"] == 0 for r in fed.ledger().values())
    for f in ("theta_L", "psi"):
        torch.testing.assert_close(getattr(out["cuda"], f).cpu(), getattr(out["cpu"], f),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_sync_round_launches_sqnorm_and_scale_noise_and_matches_the_cpu():
    """N x G x leaves sqnorm and N x leaves scale_noise launches a round and
    nothing else; the card's round against the CPU's (the plain versions)
    within rtol 1e-4, atol 1e-5 (GEMMs and norms in other orders); a fully
    refused round returns its input."""
    dev = _device()
    lm = LM(DENSE_124M.reduced())
    n, G = 3, 2
    toks = torch.randint(0, lm.cfg.vocab, (n, 4, 16), generator=torch.Generator().manual_seed(1))
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    owners = [DataOwner(n=1000, epsilon=1.0, xi=1.0) for _ in range(n)]
    out = {}
    for d in (dev, torch.device("cpu")):
        fed = Federation(owners, FederationConfig(horizon=1, sigma=1e-2, theta_max=100.0),
                         strategy="sync", device=d)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], lr=0.05, privatizer=PrivatizerConfig(
            xi=1.0, granularity="microbatch", n_microbatches=G, fused_kernel=True))
        params = lm.init(seed=2, device=d)
        before = dict(tkernel.launches)
        out[d.type] = fed.sync_round(params, batches, trandom.PRNGKey(5, device=d))
        if d.type == "cuda":
            n_leaves = len(tree_flatten(params)[0])
            assert tkernel.launches == {"dp_round": before["dp_round"],
                                        "sqnorm": before["sqnorm"] + n * G * n_leaves,
                                        "scale_noise": before["scale_noise"] + n * n_leaves}
        assert fed.sync_round(out[d.type], batches, trandom.PRNGKey(6, device=d)) is out[d.type]
    for a, b in zip(tree_flatten(out["cuda"])[0], tree_flatten(out["cpu"])[0]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_paged_bank_lookup_on_the_card():
    from repro_torch.federation import PagedBank
    dev = _device()
    ids = torch.tensor([2, 5, 9, 12, 20, 20], dtype=torch.int32, device=dev)
    bank = PagedBank(torch.zeros((6, 3), device=dev), ids, 20)
    owners = torch.arange(20, dtype=torch.int64, device=dev)
    slot, hit = bank.lookup(owners)
    assert slot.device.type == "cuda" and slot.dtype == torch.int64
    assert bank.hot_ids.dtype == torch.int32
    want_slot, want_hit = PagedBank(torch.zeros((6, 3)), ids.cpu(), 20).lookup(owners.cpu())
    assert torch.equal(slot.cpu(), want_slot) and torch.equal(hit.cpu(), want_hit)
    assert hit.cpu().nonzero().reshape(-1).tolist() == [2, 5, 9, 12]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["f32", "int8", "tree", "grouped", "faults"])
def test_paged_dispatch_on_the_card(form):
    # a paged session on the card (n_hot 3 of 5 owners, so rows evict and
    # load between dispatches) equals the flat session on the card bit for
    # bit, through the same kernels (tree: tree_delta at the hot slot)
    dev = _device()
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=2)
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (12, 4, 16), generator=gen, dtype=torch.int32)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    chunks = ([0, 1, 0, 2], [3, 4, 3, 4], [1, 0, 2, 2])
    fkw = dict(mechanism="tree", tree_depth=2) if form == "tree" else {}
    if form == "faults":
        from repro_torch.federation import FaultPlan, FaultPolicy
        fkw["fault_policy"] = FaultPolicy(max_faults=2, window=8)
    out = {}
    for paged in (False, True):
        fed = Federation([DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0) for i in range(5)],
                         FederationConfig.from_target_lr(0.05, n_owners=5, horizon=3,
                                                         sigma=1e-2), device=dev, **fkw)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True,
                      bank_dtype="int8" if form == "int8" else None,
                      privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2, fused_kernel=True))
        state = fed.init_paged_state(params, n_hot=3) if paged else fed.init_state(params)
        before = {**tkernel.launches, **bkernel.launches, **nkernel.launches}
        for c, seq in enumerate(chunks):
            kw = dict(owner_parallel=True, max_group=None) if form == "grouped" else {}
            if form == "faults":
                kw["faults"] = FaultPlan(drop=0.2, nonfinite=0.2, corrupt=0.2)
            state, ms = fed.run_rounds(state, {k: v[4 * c:4 * c + 4] for k, v in batches.items()},
                                       seq, key=trandom.PRNGKey(10 + c, device=dev), **kw)
        after = {**tkernel.launches, **bkernel.launches, **nkernel.launches}
        bank = state.bank
        if paged:
            assert fed.pager.stats["evictions"] > 0
            snap = fed.pager.snapshot(state)
            bank = snap["codes"] if form == "int8" else snap["rows"]
        else:
            bank = (bank.codes if form == "int8" else bank).cpu().numpy()
        out[paged] = dict(theta=state.theta_L.buf.cpu(), bank=bank, refused=ms["refused"].cpu(),
                          ledger=fed.reconcile(state),
                          launches={k: after[k] - before[k] for k in after})
    assert torch.equal(out[False]["theta"], out[True]["theta"])
    assert (out[False]["bank"] == out[True]["bank"]).all()
    assert torch.equal(out[False]["refused"], out[True]["refused"])
    assert out[False]["ledger"] == out[True]["ledger"]
    assert out[False]["launches"] == out[True]["launches"]
    kernel = "tree_delta" if form == "tree" else "dp_round"
    assert out[True]["launches"][kernel] > 0 and out[True]["launches"]["sqnorm"] > 0
    if form == "int8":
        assert all(out[True]["launches"][k] > 0 for k in ("absmax", "encode", "decode"))


# ------------------------------------------ col0 and the mesh -------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("cuts", [(0, 2053, 4099), (0, 1000, 3001, 4099),
                                  (0, 1_000_003, 3 * 1024 * 1024 + 77)])
def test_col0_launches_equal_the_full_row_and_the_plain_versions(cuts):
    """dp_round (single and rows), tree_delta (single and rows) and encode
    over columns [c0, c1) with col0 = c0 equal the full launch's columns and
    their plain versions at that col0, bit for bit (dp_round within the
    log1pf bound against its plain version, as above)."""
    dev = _device()
    p = cuts[-1]
    gen = torch.Generator(device=dev).manual_seed(p)
    tb = torch.randn((3, p), device=dev, generator=gen)
    acc = torch.randn((3, p), device=dev, generator=gen)
    keys = trandom.split(trandom.PRNGKey(9, device=dev), 3)
    gain, ns, w = (torch.rand(3, device=dev, generator=gen) for _ in range(3))
    full = tops.dp_round_rows(tb, acc, keys, gain, ns, w, **ROUND)
    nodes = torch.randn((4, 3, p), device=dev, generator=gen)
    counts = torch.tensor([0, 1, 2, 6], dtype=torch.int32, device=dev)
    owners = torch.tensor([1, 3, 0], dtype=torch.int64, device=dev)
    whole = nodes.clone()
    dfull = nops.tree_delta_rows_(whole, counts, owners, keys, ns)
    x = torch.randn(p, device=dev, generator=gen) * 0.1
    codes, scale, err = bops.encode_row(x, keys[0], "int8")
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        sl = slice(c0, c1)
        rows = tops.dp_round_rows(tb[:, sl].contiguous(), acc[:, sl].contiguous(), keys, gain,
                                  ns, w, col0=c0, **ROUND)
        one = tops.dp_round_flat(tb[0, sl], acc[0, sl], keys[0], gain[:1], ns[:1], w[:1],
                                 col0=c0, **ROUND)
        plain = tref.dp_round_ref(tb[0, sl], acc[0, sl], trandom.bits_range(keys[0], c0, c1),
                                  gain[:1], ns[:1], w[:1], **ROUND)
        for a, b, c, d in zip(rows, full, one, plain):
            assert torch.equal(a, b[:, sl]) and torch.equal(c, b[0, sl])
            torch.testing.assert_close(c, d, rtol=1e-6, atol=1e-6)
        part = nodes[:, :, sl].clone()
        d = nops.tree_delta_rows_(part, counts, owners, keys, ns, col0=c0)
        assert torch.equal(d, dfull[:, sl]) and torch.equal(part, whole[:, :, sl])
        plain_nodes = nodes[:, :, sl].clone()
        pd = nref.tree_delta_inplace_ref(plain_nodes, counts, owners[:1],
                                         trandom.bits_range(keys[0], c0, c1), ns[:1])
        assert torch.equal(d[0], pd)
        pc, _, pe = bops.encode_row(x[sl], keys[0], "int8", col0=c0, scale=scale)
        assert torch.equal(pc, codes[sl]) and torch.equal(pe, err[sl])
        rc, _, re = bref.encode_row_ref(x[sl], keys[0], "int8", col0=c0, scale=scale)
        assert torch.equal(pc, rc) and torch.equal(pe, re)
        assert torch.equal(bops.row_absmax(x[sl]), bref.row_scales_ref(x[sl].reshape(1, -1),
                                                                       1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["f32", "bf16", "int8", "tree"])
def test_one_by_one_nccl_mesh_equals_the_unmeshed_engine_on_the_card(form):
    """A world of one over NCCL and the 1x1 mesh: sequential and grouped
    dispatches equal their unmeshed twins on the card bit for bit, with the
    same launches; the process group is torn down after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dev = _device()
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=2, device=dev)
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (12, 4, 16), generator=gen, dtype=torch.int32)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    seq = [0, 1, 2, 3, 1, 0, 3, 2, 2, 2, 1, 0]
    tree = form == "tree"
    bank_dtype = {"bf16": torch.bfloat16, "int8": "int8"}.get(form)
    mech = dict(mechanism="tree", tree_depth=2) if tree else {}
    mesh = make_host_mesh()
    try:
        for grouped in (False, True):
            out = []
            for m in (None, mesh):
                fed = Federation([DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0)
                                  for i in range(4)],
                                 FederationConfig.from_target_lr(0.05, n_owners=4,
                                                                 horizon=8 if tree else 2,
                                                                 sigma=1e-2),
                                 device=dev, **mech)
                fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True,
                              bank_dtype=bank_dtype, mesh=m,
                              privatizer=PrivatizerConfig(xi=1.0, n_microbatches=2,
                                                          fused_kernel=True))
                before = {**tkernel.launches, **nkernel.launches, **bkernel.launches}
                state, ms = fed.run_rounds(fed.init_state(params), batches, seq,
                                           key=trandom.PRNGKey(5, device=dev),
                                           owner_parallel=grouped)
                after = {**tkernel.launches, **nkernel.launches, **bkernel.launches}
                bank = state.bank
                parts = ([bank.codes, bank.scales, bank.residual]
                         if isinstance(bank, QuantBank) else [bank])
                parts += [state.theta_L.buf] + [ms[k] for k in sorted(ms)]
                if tree:
                    parts += [state.tree.nodes, state.tree.counts]
                out.append(([t.cpu() for t in parts], fed.reconcile(state),
                            {k: after[k] - before[k] for k in after}))
            (a, la, ka), (b, lb, kb) = out
            assert all(torch.equal(x, y) for x, y in zip(a, b)) and la == lb and ka == kb
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_one_by_one_nccl_mesh_save_adds_at_most_a_piece_to_the_card(tmp_path, monkeypatch,
                                                                     paged):
    """A 1x1-mesh save_session over NCCL, in pieces of 1 MiB (or one row
    where a row is larger), raises the card's peak by no more than one
    piece over the state (no global array on the device; a paged state's
    flush picks its hot rows a piece at a time, three copies of a piece),
    beside the few small index tensors of the flush and the barrier; it writes the unmeshed
    twin's arrays bit for bit, and the meshed restore resumes as the
    uninterrupted run, bit for bit."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.checkpoint import flatten_with_paths, store
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.setattr(store, "PIECE_BYTES", 1 << 20)
    dev = _device()
    cfg = DENSE_124M.reduced()
    lm = LM(cfg)
    params = lm.init(seed=2, device=dev)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (8, 4, 16), generator=gen, dtype=torch.int32)
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, dims=2)}
    seq = [0, 1, 2, 3, 1, 0, 3, 2]

    def session(m):
        fed = Federation([DataOwner(n=100 * (i + 1), epsilon=1.0, xi=1.0) for i in range(4)],
                         FederationConfig.from_target_lr(0.05, n_owners=4, horizon=8,
                                                         sigma=1e-2), device=dev)
        fed.make_step(lambda p, b: lm.loss(p, b)[0], pack_params=True, mesh=m,
                      privatizer=PrivatizerConfig(xi=1.0, granularity="example",
                                                  fused_kernel=True))
        return fed, fed.init_paged_state(params, n_hot=4) if paged else fed.init_state(params)

    def dispatch(fed, st, d):
        sl = slice(4 * d, 4 * d + 4)
        return fed.run_rounds(st, {k: v[sl] for k, v in batches.items()}, seq[sl],
                              key=trandom.PRNGKey(9 + d, device=dev))[0]

    def arrays(directory):
        step = store.latest_step(directory)
        with np.load(f"{directory}/step_{step:08d}/arrays.npz") as z:
            return {k: z[k] for k in z.files}
    mesh = make_host_mesh()
    try:
        files = {}
        for tag, m in (("twin", None), ("mesh", mesh)):
            fed, st = session(m)
            st = dispatch(fed, st, 0)
            fed.reconcile(st)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            fed.save_session(str(tmp_path / tag), st)
            if m is not None:
                piece = max(store.PIECE_BYTES, st.theta_L.buf.numel() * 4)     # or one row
                # the writer's own pieces never reach the device; a paged
                # flush picks its hot rows over the row group, which holds a
                # piece three times on a 1x1 mesh (the rank's candidate
                # rows, their gather, the picked rows)
                bound = (3 if paged else 1) * piece + (1 << 16)
                peak = torch.cuda.max_memory_allocated() - held
                assert peak <= bound, (peak, bound)
                whole = dispatch(fed, st, 1)
                whole = [t.cpu() for t in flatten_with_paths(whole).values()]
            files[tag] = arrays(str(tmp_path / tag))
        assert list(files["mesh"]) == list(files["twin"])
        for k, a in files["twin"].items():
            assert files["mesh"][k].dtype == a.dtype and np.array_equal(files["mesh"][k], a), k
        fed, like = session(mesh)
        st = dispatch(fed, fed.restore_session(str(tmp_path / "mesh"), like), 1)
        assert all(torch.equal(a, b.cpu())
                   for a, b in zip(whole, flatten_with_paths(st).values()))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_one_by_one_nccl_mesh_prefill_equals_the_unmeshed_with_flash():
    """The reduced yi-6b's prefill (attn_backend "pallas": flash on the
    card) through build_prefill_step on the 1x1 mesh of a world of one over
    NCCL, its params and batch DTensors, equals the unmeshed step bit for
    bit, with one flash launch a layer; the process group is torn down."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_prefill_step, place
    dev = _device()
    cfg = get_config("yi-6b").reduced()
    lm = LM(cfg, attn_backend="pallas")
    params = lm.init(seed=3, device=dev)
    shape = ShapeConfig("p", 256, 2, "prefill")
    toks = torch.randint(0, cfg.vocab, (2, 256), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3)).to(dev)
    mesh = make_host_mesh()
    try:
        with torch.no_grad():
            want = build_prefill_step(cfg, shape, None, model=lm).step(params, {"tokens": toks})
            meshed = build_prefill_step(cfg, shape, mesh, model=lm)
            before = fkernel.launches["flash_attention"]
            got = meshed.step(*place(meshed.in_shardings, params, {"tokens": toks}))
            launched = fkernel.launches["flash_attention"] - before
        assert launched == cfg.n_layers
        assert torch.equal(got.full_tensor(), want)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_op_fakes_give_the_real_outputs_shapes(dtype):
    """Each kernel's custom op on meta tensors (its fake) gives the shapes,
    dtypes and count of the outputs the launch gives on the card."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, H, Kv, hd = 2, 100, 4, 2, 64
    q, k, v = (torch.randn(shape, device=dev, generator=g, dtype=dtype)
               for shape in ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd)))
    N, P, Q = 16, 32, 32
    sv, sk = (torch.randn(shape, device=dev, generator=g, dtype=dtype)
              for shape in ((B, S, H, P), (B, S, H, N)))
    ld, sg = (torch.rand((B, S, H), device=dev, generator=g) * -0.1 for _ in range(2))
    nc = -(-S // Q)
    cots = [torch.randn(shape, device=dev, generator=g)
            for shape in ((B, S, H, P), (B, nc, H, N, P), (B, S, H), (B, nc, H))]
    calls = [(fkernel.flash_attention_cuda, (q, k, v), dict(causal=True, window=None)),
             (skernel.ssd_chunk_scan_cuda, (sv, ld, sk, sk, sg, Q), {}),
             (skernel.ssd_chunk_scan_bwd_cuda, (*cots, sv, ld, sk, sk, sg, Q), {})]
    for op, args, kw in calls:
        real = op(*args, **kw)
        fake = op(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args), **kw)
        real = real if isinstance(real, tuple) else (real,)
        fake = fake if isinstance(fake, tuple) else (fake,)
        assert [(tuple(t.shape), t.dtype) for t in real] == \
            [(tuple(t.shape), t.dtype) for t in fake]


@pytest.mark.cuda
def test_the_counter_sees_the_flash_launch():
    """analysis.op_cost counts flash's launch through its custom op, by its
    registered formula (PERF.md row 8), and the launch happens once."""
    from repro_torch.analysis.op_cost import OpCost
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(1)
    B, S, H, Kv, hd = 2, 128, 4, 2, 64
    q = torch.randn((B, S, H, hd), device=dev, generator=g)
    k, v = (torch.randn((B, S, Kv, hd), device=dev, generator=g) for _ in range(2))
    before = fkernel.launches["flash_attention"]
    with torch.no_grad(), OpCost() as counter:
        out = fops.flash_attention(q, k, v, causal=True)
    assert fkernel.launches["flash_attention"] - before == 1
    names = {e[0] for e in counter.events}
    assert "repro_torch.flash_attention_cuda" in names
    assert counter.summary()["flops"] == 4 * B * H * hd * S * (S + 1) // 2
    torch.testing.assert_close(out, fref.flash_attention_ref(q, k, v, causal=True),
                               rtol=0, atol=2e-5)
