"""Data of the port: the owner-sharded token pipeline of the deep path and
the synthetic convex datasets (Lending Club and NY SPARCS stand-ins) and
token batches."""
from repro_torch.data.pipeline import (OwnerDataPipeline, OwnerShard,
                                      synthetic_owner_shards)
from repro_torch.data.synthetic import GENERATORS, health, lending, owner_shards, token_batch

__all__ = ["GENERATORS", "OwnerDataPipeline", "OwnerShard", "health", "lending",
           "owner_shards", "synthetic_owner_shards", "token_batch"]
