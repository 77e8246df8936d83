"""dp_kernels_ms: device time of the privatizer's kernels (`dp_round` /
`dp_round_rows` and `sqnorm`) per round of the profiled dispatches, in ms."""
from bench.harness.trace import kernel_group


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.profile_rounds:
        return None
    s = sum(sec for name, (sec, _) in p.kernels.items()
            if kernel_group(name) in ("dp_round", "sqnorm"))
    return 1e3 * s / ctx.profile_rounds if s else None
