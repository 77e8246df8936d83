"""host_enqueue_ms: host time inside the window's `run_rounds` calls per
round, in ms. A call starts by copying its owner sequence to the card,
which waits for the previous dispatch's kernels, so a device-bound cell
reads its device time here too."""


def read(ctx):
    rounds = ctx.window_dispatches * ctx.cell.traffic["rounds_per_dispatch"]
    if not rounds:
        return None
    return 1e3 * ctx.window_host_in_call_s / rounds
