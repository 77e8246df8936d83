"""tokens_per_s: training tokens (batch x sequence) of the window's answered
rounds over the window's host-clock length, from its first dispatch to the
synchronize after the first dispatch boundary past `--seconds`."""


def read(ctx):
    if not ctx.window_s:
        return None
    t = ctx.cell.traffic
    return ctx.window_rounds * t["batch"] * t["seq"] / ctx.window_s
