"""host_syncs: host syncs (`repro_torch.telemetry`'s count under the sync
debug mode) inside `session.run_rounds` per dispatch of the traced set
(`harness.spans`). None off the card or where the program has no
telemetry."""
from bench.harness.spans import traced


def read(ctx):
    t = traced(ctx)
    if t is None or not t.dispatches:
        return None
    return t.syncs / t.dispatches
