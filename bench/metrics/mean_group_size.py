"""mean_group_size: rounds per `dp_round` launch in the window, from the
kernel's launch counter: the grouped driver launches one per group (the
sequential driver one per round). The counter moves only on the card."""


def read(ctx):
    launches = ctx.window_launches.get("dp_round", 0)
    if not launches:
        return None
    return ctx.window_dispatches * ctx.cell.traffic["rounds_per_dispatch"] / launches
