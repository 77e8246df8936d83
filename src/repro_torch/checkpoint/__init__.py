"""Checkpoints of the port's states and the paged bank's cold-tier row
stores (counterpart of `repro.checkpoint`, in the same on-disk format)."""
from repro_torch.checkpoint.store import (MemmapRowStore, MemoryRowStore, flatten_with_paths,
                                          latest_step, load_aux_arrays, load_checkpoint,
                                          load_manifest, save_checkpoint)

__all__ = ["MemmapRowStore", "MemoryRowStore", "flatten_with_paths", "latest_step",
           "load_aux_arrays", "load_checkpoint", "load_manifest", "save_checkpoint"]
