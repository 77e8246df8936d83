"""The control and the planted faults of bench/control.py fail the check:
the reference in the program's place with half of each microbatch left
out, or with each group reading the state of one group earlier (a stale
carry between groups), on the CPU at a tiny size, each failing
grad_leaf_gap among others; in TF32 on the card (the precision below
the configurations' f32 with TF32 off), at a small size."""
import dataclasses

import pytest
import torch

from bench import control, testing


def _fails_on_the_gradient(name, mode):
    r = control.readings(testing.tiny(name), testing.SEEDS[name], mode, "cpu")
    assert r["fails"], r
    assert r["numbers"]["owner_mismatch"] == 0 and r["numbers"]["ledger_mismatch"] == 0
    assert r["numbers"]["grad_leaf_gap"] > testing.tiny(name).limits["grad_leaf_gap"], r


@pytest.mark.parametrize("name", testing.CELLS)
def test_half_batch_control_fails(name):
    _fails_on_the_gradient(name, "half_batch")


@pytest.mark.parametrize("name", testing.CELLS)
def test_stale_carry_control_fails(name):
    _fails_on_the_gradient(name, "stale_carry")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", testing.CELLS)
def test_tf32_control_fails(card, name):
    c = testing.tiny(name)
    cfg = dict(c.config, d_model=512, n_heads=8, head_dim=64, d_ff=1024, vocab=4096,
               n_kv_heads=8 if c.config["n_kv_heads"] == c.config["n_heads"] else 2)
    c = dataclasses.replace(c, config=cfg, traffic=dict(c.traffic, seq=256))
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        assert control.readings(c, seed, "tf32", card)["fails"]
