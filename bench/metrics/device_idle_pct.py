"""device_idle_pct: the share of the profiled dispatches' span in which no
kernel ran on the card, in percent."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.kernels or p.span_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.span_s)
