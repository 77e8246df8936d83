"""The port's one rule for a device argument: None means CUDA.

Every entry point that makes tensors from nothing (keys, weights, packed
buffers, the session's state) sends its `device` argument through
`resolve_device`, so a caller who names no device gets the card, or an
error where there is none. Nothing carries on on the CPU unless the caller
asks for it with ``device="cpu"``, as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or "cuda" when None; raises when CUDA is asked for and
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the port runs on CUDA and no CUDA device is available; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return dev
