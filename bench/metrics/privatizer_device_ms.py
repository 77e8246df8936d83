"""privatizer_device_ms: device time of the ops launched inside the
program's `engine.*` and `privatizer.*` spans and outside their `model.*`
children, per round of the traced set (`harness.spans`), in ms: the
round's passes over P (theta_bar, the gathered row, the accumulator,
clip, `sqnorm`, `dp_round`, the writes) and the ledger's scatters."""
from bench.harness.spans import traced


def read(ctx):
    t = traced(ctx)
    if t is None or not t.rounds or not t.device_s:
        return None
    return 1e3 * t.privatizer_device_s / t.rounds
