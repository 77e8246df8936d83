"""The check catches each fault a training cell can have, planted in the
program underneath a whole tiny run on the CPU: a step that returns its
state unchanged, half of each microbatch left out (the mean over the
rest), and an owner altered where the schedule draws it."""
import copy
import time

import pytest
import torch

from bench import testing
from bench.harness import cell


def _unchanged(monkeypatch):
    from repro_torch.federation import Federation
    orig = Federation.run_rounds

    def run_rounds(self, state, *a, **k):
        _, metrics = orig(self, copy.deepcopy(state), *a, **k)
        return state, metrics
    monkeypatch.setattr(Federation, "run_rounds", run_rounds)


def _half_batch(monkeypatch):
    from repro_torch.models import LM
    orig = LM.loss

    def loss(self, params, batch, **k):
        return orig(self, params, {n: v[:max(1, v.shape[0] // 2)] for n, v in batch.items()},
                    **k)
    monkeypatch.setattr(LM, "loss", loss)


def _owner_altered(monkeypatch):
    from repro_torch.federation.schedules import UniformSchedule
    orig = UniformSchedule.draw

    def draw(self, key, n_owners, horizon):
        out = orig(self, key, n_owners, horizon).clone()
        out[0] = (out[0] + 1) % n_owners
        return out
    monkeypatch.setattr(UniformSchedule, "draw", draw)


FAULTS = {"unchanged": (_unchanged, "update_leaves_off"),
          "unchanged.leaf": (_unchanged, "grad_leaf_gap"),
          "half_batch": (_half_batch, "grad_norm_gap"),
          "half_batch.leaf": (_half_batch, "grad_leaf_gap"),
          "owner_altered": (_owner_altered, "owner_mismatch")}


@pytest.mark.parametrize("name", testing.CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(monkeypatch, name, fault):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    c = testing.tiny(name)
    out = cell.run(c, testing.SEEDS[name], 0.1, False, torch.device("cpu"), time.time())
    assert out["correct"] is False
    chk = out["checks"][number]
    assert not float(chk["value"]) <= chk["limit"], out["_lines"]
