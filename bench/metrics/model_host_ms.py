"""model_host_ms: host time inside the program's `model.forward` and
`model.backward` spans per round of the traced set (`harness.spans`), in
ms: the enqueue of the model's forward and backward."""
from bench.harness.spans import traced


def read(ctx):
    t = traced(ctx)
    if t is None or not t.rounds:
        return None
    return 1e3 * t.model_host_s / t.rounds
