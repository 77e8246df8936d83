"""The traffic generator: one general reader of a traffic file that makes
every input of a run from its seed.

A traffic file states the federation (owners, records per owner, the
budget and horizon, the clip norm, the rates), the driver
("sequential": `run_rounds`; "grouped": `run_rounds(owner_parallel=True)`
with its `max_group`), the batch (rows, sequence length, microbatches) and
the dispatch (rounds per call, how many distinct dispatches the window
cycles through, how many the trace profiles) and the schedule's key. The
first, checked dispatch has the window's shape: K rounds, drawn ahead of
the window's.

The owner sequence of every dispatch is drawn by the program's schedule
in one call (`draw`) from the traffic's fixed `schedule_key`
(PRNGKey(schedule_key)), so every seed runs the same rounds, groups and
group sizes in the same order: the work of a run does not depend on its
seed. The seed relabels the owners (a permutation of their ids) and makes,
on the device:
  * every owner's shard of `records_per_owner` token rows, uniform over the
    vocabulary (the owners' data);
  * the keys: split(PRNGKey(seed)) -> the checked dispatch's key and the
    window's, split again into one key per dispatch;
  * each round's batch: the owner's next `batch` rows from its cursor
    (each owner reads its shard in order, wrapping), labels the rows
    shifted left by one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from bench.reference import threefry as T

N_KEYS = 1 << 14             # dispatch keys made for one run


@dataclass
class Inputs:
    sched_key: torch.Tensor          # (2,) int64 words of the schedule's key
    relabel: np.ndarray              # (owners,) the seed's permutation of owner ids
    check_key: torch.Tensor          # (2,) int64 words of the checked dispatch
    dispatch_keys: torch.Tensor      # (N_KEYS, 2) int64 words, one per dispatch
    check_seq: np.ndarray            # (K,) int owners
    check_batch: Dict[str, torch.Tensor]      # leaves (K, B, S) int32
    pool_seqs: np.ndarray            # (pool, K) int owners
    pool_batches: Dict[str, torch.Tensor]     # leaves (pool, K, B, S) int32

    def dispatch(self, d: int):
        """(batches, owner sequence) of the window's dispatch d."""
        i = d % self.pool_seqs.shape[0]
        return {k: v[i] for k, v in self.pool_batches.items()}, self.pool_seqs[i]


def as_key(words: torch.Tensor) -> torch.Tensor:
    """Key words (int64) as the program's (2,) uint32 key."""
    return words.to(torch.uint32)


def make(traffic: dict, vocab: int, seed: int, device: torch.device,
         draw: Callable[[torch.Tensor, int], torch.Tensor]) -> Inputs:
    """The run's inputs. `draw(key, n)` is the program's schedule: n owners
    from a (2,) uint32 key, as a (n,) device tensor."""
    n, recs, B, S = (traffic["owners"], traffic["records_per_owner"], traffic["batch"],
                     traffic["seq"])
    K, pool = traffic["rounds_per_dispatch"], traffic["dispatch_pool"]
    k_sched = T.prng_key(traffic["schedule_key"], device)
    k_check, k_window = T.split(T.prng_key(seed, device))
    gen = torch.Generator(device=device)
    gen.manual_seed(2 * int(seed) + 1)
    relabel = torch.randperm(n, generator=gen, device=device).cpu().numpy()
    seqs = relabel[draw(as_key(k_sched), (1 + pool) * K).cpu().numpy().astype(np.int64)]
    shards = torch.randint(0, vocab, (n, recs, S), generator=gen, device=device,
                           dtype=torch.int32)
    cursor = np.zeros(n, np.int64)
    rows = np.empty((seqs.size, B), np.int64)
    for r, o in enumerate(seqs):
        rows[r] = (cursor[o] + np.arange(B)) % recs
        cursor[o] = (cursor[o] + B) % recs
    owners = torch.from_numpy(np.repeat(seqs[:, None], B, axis=1)).to(device)
    tokens = shards[owners, torch.from_numpy(rows).to(device)]        # (rounds, B, S)
    del shards
    labels = torch.roll(tokens, -1, dims=-1)
    return Inputs(
        sched_key=k_sched, relabel=relabel, check_key=k_check,
        dispatch_keys=T.split(k_window, N_KEYS),
        check_seq=seqs[:K], check_batch={"tokens": tokens[:K], "labels": labels[:K]},
        pool_seqs=seqs[K:].reshape(pool, K),
        pool_batches={"tokens": tokens[K:].reshape(pool, K, B, S),
                      "labels": labels[K:].reshape(pool, K, B, S)})
