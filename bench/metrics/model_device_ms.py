"""model_device_ms: device time of the ops launched inside the program's
`model.*` spans per round of the traced set (`harness.spans`), in ms:
GEMMs and the model's element-wise work, forward and backward."""
from bench.harness.spans import traced


def read(ctx):
    t = traced(ctx)
    if t is None or not t.rounds or not t.device_s:
        return None
    return 1e3 * t.model_device_s / t.rounds
