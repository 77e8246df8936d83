"""mfu: the window's model FLOPs (forward and backward of every answered
round, `roofline.flops.train_flops`) over the window's host-clock length
and the card's f32 peak, in percent."""
from bench.roofline import F32_FLOPS
from bench.roofline.flops import train_flops


def read(ctx):
    if ctx.device.type != "cuda" or not ctx.window_rounds:
        return None
    t = ctx.cell.traffic
    flops = ctx.window_rounds * train_flops(ctx.model, t["batch"], t["seq"])
    return 100.0 * flops / (ctx.window_s * F32_FLOPS)
