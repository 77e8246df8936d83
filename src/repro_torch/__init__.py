"""PyTorch/CUDA port of the async-DP federation (the JAX package `repro`
is the reference it is held against).

Modules mirror `repro`'s layout: `federation` (the Federation session and
the flat deep engine), `kernels` (hand-written CUDA kernels for Hopper with
their plain PyTorch versions), `models`, `configs`, `data`, plus `random`
(jax's threefry key stream) and `convert` (weights from the reference).
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
