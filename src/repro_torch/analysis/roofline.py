"""Roofline terms of a step from its counted cost (no real hardware).

The counterpart of ``repro/analysis/roofline.py``, with an NVIDIA H100
SXM's peaks (its data sheet) in place of TPU v5e's. Inputs are one
device's counts from ``analysis.op_cost`` (the ops each rank runs on its
local tensors, as the reference's `cost_analysis` runs on the
SPMD-partitioned module):

    compute    = sum over product dtypes of flops_d / PEAK_FLOPS[d]   [s]
    memory     = bytes_per_device / HBM_BW                           [s]
    collective = coll_bytes_per_device / NVLINK_BW                   [s]

The compute peak is the one of the dtype the products run in: 67 TFLOP/s
for f32 (the port runs its models in f32 with TF32 off; its own kernels
run f32 FMAs whatever they read), 989 TFLOP/s for dense bf16 and f16 on
the tensor cores. HBM is 3.35 TB/s, NVLink 450 GB/s each way.

The reference's `parse_collective_bytes` reads collective operand bytes
out of HLO text; it has no counterpart here, because the counter sees the
collectives themselves and gives those bytes (``op_cost``).
"""
from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM5 data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
HBM_BW = 3.35e12             # bytes/s / device
NVLINK_BW = 450e9            # bytes/s, one direction


def peak_flops(dtype: str) -> float:
    """The dense peak for products in `dtype` (a torch dtype name; f32 for
    any other)."""
    return PEAK_FLOPS.get(str(dtype).replace("torch.", ""), PEAK_FLOPS["float32"])


def roofline_terms(flops_per_dev: float, bytes_per_dev: float, coll_bytes_per_dev: float,
                   flops_by_dtype: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """The reference's terms and keys. `flops_by_dtype` ({dtype: flops})
    takes each dtype's flops at its own peak; without it every flop is
    taken at the f32 peak."""
    by = flops_by_dtype or {"float32": flops_per_dev}
    compute = sum(f / peak_flops(d) for d, f in by.items())
    memory = bytes_per_dev / HBM_BW
    coll = coll_bytes_per_dev / NVLINK_BW
    dom = max((compute, "compute"), (memory, "memory"),
              (coll, "collective"))[1]
    return {"compute_s": compute, "memory_s": memory, "collective_s": coll,
            "dominant": dom,
            "step_lower_bound_s": max(compute, memory, coll)}


def flops_by_dtype(cost: Dict[str, float]) -> Dict[str, float]:
    """The flops_<dtype> entries of an ``op_cost`` summary."""
    return {k[len("flops_"):]: v for k, v in cost.items() if k.startswith("flops_")}


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6*N*D (train: fwd+bwd) or 2*N*D (inference fwd only)."""
    per_tok = 6 if kind == "train" else 2
    return float(per_tok) * n_params_active * tokens
