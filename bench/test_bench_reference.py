"""The plain reference against the port on the CPU at reduced sizes: its
threefry copy against `repro_torch.random` and the kernels' Laplace draw,
its models' loss and gradient against `repro_torch.models.LM` (leaf
names, shapes and packing order included), and its weights' draw."""
import dataclasses
import json
import math

import pytest
import torch

from bench.harness import program, spec
from bench.reference import federation as RF
from bench.reference import model as RM
from bench.reference import threefry as T



@pytest.mark.parametrize("seed", [0, 2**31 + 3, 2**40 + 1])
def test_split_fold_in_bits_randint_match_the_port(seed):
    from repro_torch import random
    key = random.PRNGKey(seed, device="cpu")
    words = T.prng_key(seed)
    assert torch.equal(random.split(key, 5).to(torch.int64), T.split(words, 5))
    assert torch.equal(random.fold_in(key, 9).to(torch.int64), T.fold_in(words, 9))
    assert torch.equal(random.bits_range(key, 3, 40).to(torch.int64), T.bits(words, 3, 40))
    assert torch.equal(random.randint(key, (50,), 0, 16).to(torch.int64),
                       T.randint(words, 50, 0, 16))


def test_laplace_rows_match_the_kernel_plain_version():
    from repro_torch import random
    from repro_torch.kernels.dp_clip_noise.ref import laplace_from_bits_ref
    key = random.PRNGKey(11, device="cpu")
    want = laplace_from_bits_ref(random.bits_range(key, 0, 1000))
    old = T.BLOCK
    try:
        T.BLOCK = 300                 # several blocks, a ragged last one
        got = T.laplace_rows(T.prng_key(11), 0, 1000)
    finally:
        T.BLOCK = old
    assert torch.equal(got, want)


def _reduced(name):
    from repro_torch.configs.registry import get_config
    cfg = get_config(name).reduced()
    if name.startswith("qwen"):
        cfg = dataclasses.replace(cfg, tie_embeddings=True, norm_eps=1e-6, rope_theta=1e6)
    d = dataclasses.asdict(cfg)
    return cfg, RM.ModelSpec.from_config(d)


@pytest.mark.parametrize("name", ["zamba2-2.7b", "qwen1.5-110b"])
def test_loss_and_gradient_match_the_port(name):
    from repro_torch.models import LM
    from repro_torch.tree_util import tree_flatten
    cfg, ms = _reduced(name)
    lm = LM(cfg, remat=False)
    assert program.leaf_paths(lm.init(device="meta")) == [n for n, _, _ in RM.layout(ms)]
    params = RM.make_params(ms, 5, "cpu")
    tree = program.param_tree(lm, {n: p.clone().requires_grad_() for n, p in params.items()})
    mine = {n: p.clone().requires_grad_() for n, p in params.items()}
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (2, 80), generator=gen)   # a ragged last SSD chunk
    labels = torch.roll(toks, -1, 1)
    lp = lm.loss(tree, {"tokens": toks, "labels": labels})[0]
    lr = RM.loss(mine, toks, labels, ms)
    lp.backward()
    lr.backward()
    assert abs(float(lp.detach()) - float(lr.detach())) <= 1e-5 * abs(float(lr.detach()))
    for n, leaf in zip(mine, tree_flatten(tree)[0]):
        ref = mine[n].grad
        assert float((leaf.grad - ref).norm()) <= 1e-4 * float(ref.norm()) + 1e-12, n


@pytest.mark.parametrize("name", ["qwen1.5-0.5b"])
def test_configuration_files_build_the_published_sizes(name):
    with open(spec.BENCH_DIR / "configs" / f"{name}.json") as f:
        c = json.load(f)
    assert program.model_config(c).param_count() == RM.n_params(RM.ModelSpec.from_config(c))
    assert RM.n_params(RM.ModelSpec.from_config(c)) == c["params"]


def test_weights_are_one_draw_of_the_seed():
    _, ms = _reduced("zamba2-2.7b")
    a, b = RM.make_params(ms, 7, "cpu"), RM.make_params(ms, 7, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed"], RM.make_params(ms, 8, "cpu")["embed"])
    assert torch.equal(a["blocks.mamba.A_log"][1],
                       torch.log(torch.linspace(1.0, 16.0, ms.ssm_heads)))
    assert math.isclose(float(a["embed"].std()), 0.02, rel_tol=0.1)


def test_grouping_matches_the_port():
    from repro_torch.federation.schedules import auto_max_group, partition_conflict_free
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        seq = torch.randint(0, 6, (20,), generator=gen).tolist()
        assert RF.auto_cap(seq) == auto_max_group(seq)
        assert RF.partition(seq, 3) == partition_conflict_free(seq, 3)
