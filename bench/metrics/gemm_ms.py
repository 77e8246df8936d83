"""gemm_ms: device time of the GEMM kernels (cuBLAS and CUTLASS names) per
round of the profiled dispatches, in ms."""
from bench.harness.trace import kernel_group


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.profile_rounds:
        return None
    s = sum(sec for name, (sec, _) in p.kernels.items() if kernel_group(name) == "gemm")
    return 1e3 * s / ctx.profile_rounds if s else None
