"""dp_round_roofline: the `dp_round` kernel's bound over its measured time,
in percent. Every round's row goes through exactly one launch (one per
round, or one per group of rows), so the profiled dispatches move 16 B x P
x rounds; the bound is those bytes over the HBM peak."""
from bench.reference.model import n_params
from bench.harness.trace import kernel_group
from bench.roofline import bound_s
from bench.roofline.kernels import dp_round_bytes


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.profile_rounds:
        return None
    s = sum(sec for name, (sec, _) in p.kernels.items() if kernel_group(name) == "dp_round")
    if not s:
        return None
    return 100.0 * bound_s(0.0, dp_round_bytes(n_params(ctx.model), ctx.profile_rounds)) / s
