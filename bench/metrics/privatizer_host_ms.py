"""privatizer_host_ms: host time inside the program's `engine.*` and
`privatizer.*` spans, less their `model.*` children, per round of the
traced set (`harness.spans`), in ms: the enqueue of the round's own work
around the model (gather, theta_bar, clip, noise, writes, ledger)."""
from bench.harness.spans import traced


def read(ctx):
    t = traced(ctx)
    if t is None or not t.rounds:
        return None
    return 1e3 * t.privatizer_host_s / t.rounds
