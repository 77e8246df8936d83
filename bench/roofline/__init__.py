"""The yardstick's arithmetic: the H100's published peaks, the analytic
FLOPs of a model's training round, and the operations and bytes of one
launch of each kernel the per-layer metrics hold to a roofline.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates: 67 TFLOP/s f32 outside the tensor cores (the configurations train in
f32 with TF32 off), 989 TFLOP/s bf16, 3.35 TB/s of HBM. A launch's least
time is the larger of its operations over the compute peak and its bytes
over the HBM peak."""
from __future__ import annotations

F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, flops: float = F32_FLOPS) -> float:
    """The least time of work of `ops` operations (2 per FMA) moving
    `nbytes` bytes."""
    return max(ops / flops, nbytes / HBM_BYTES)
