"""Owner-sharded data pipeline (an own numpy copy of repro/data/pipeline.py).

Each owner holds a private token shard; `OwnerDataPipeline` yields
(owner_idx, batch) pairs following the Poisson/uniform schedule, so the
training loop touches exactly one owner's data per step — the asynchrony
contract of Algorithm 1.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np


class OwnerShard:
    def __init__(self, tokens: np.ndarray, owner_id: int):
        self.tokens = tokens          # (n_seqs, seq_len) int32
        self.owner_id = owner_id
        self._cursor = 0

    @property
    def n_records(self) -> int:
        return self.tokens.shape[0]

    def next_batch(self, batch: int) -> Dict[str, np.ndarray]:
        n = self.n_records
        idx = (self._cursor + np.arange(batch)) % n
        self._cursor = int((self._cursor + batch) % n)
        toks = self.tokens[idx]
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


class OwnerDataPipeline:
    def __init__(self, shards: List[OwnerShard], batch: int, seed: int = 0):
        self.shards = shards
        self.batch = batch
        self.rng = np.random.default_rng(seed)

    @property
    def owner_sizes(self) -> List[int]:
        return [s.n_records for s in self.shards]

    def schedule(self, horizon: int) -> np.ndarray:
        """Uniform i_k sequence (≡ rate-1 Poisson clocks)."""
        return self.rng.integers(0, len(self.shards), size=horizon)

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        while True:
            i = int(self.rng.integers(0, len(self.shards)))
            yield i, self.shards[i].next_batch(self.batch)

    def batches_for(self, owner_seq: np.ndarray) -> Dict[str, np.ndarray]:
        """Stack one batch per round for a (K,) owner sequence — the input
        layout of the fused multi-round driver (`Federation.run_rounds`):
        leaf k holds owner_seq[k]'s next microbatch, leaves become
        (K, batch, ...). Each shard's cursor advances exactly as if the
        rounds were fetched one-by-one."""
        per_round = [self.shards[int(i)].next_batch(self.batch)
                     for i in np.asarray(owner_seq)]
        if not per_round:
            raise ValueError("empty owner sequence")
        return {k: np.stack([b[k] for b in per_round])
                for k in per_round[0]}


def synthetic_owner_shards(n_owners: int, records_per_owner: int,
                           seq_len: int, vocab: int, seed: int = 0
                           ) -> List[OwnerShard]:
    rng = np.random.default_rng(seed)
    return [OwnerShard(rng.integers(0, vocab,
                                    size=(records_per_owner, seq_len),
                                    dtype=np.int32), i)
            for i in range(n_owners)]
