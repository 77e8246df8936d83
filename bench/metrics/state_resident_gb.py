"""state_resident_gb: bytes of the session's state tensors (theta_L, the
owner bank, the ledger), in GB."""


def read(ctx):
    return ctx.state_bytes / 1e9 if ctx.state_bytes else None
