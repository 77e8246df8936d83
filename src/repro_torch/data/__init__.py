"""Owner-sharded data pipeline of the port."""
from repro_torch.data.pipeline import (OwnerDataPipeline, OwnerShard,
                                      synthetic_owner_shards)

__all__ = ["OwnerDataPipeline", "OwnerShard", "synthetic_owner_shards"]
