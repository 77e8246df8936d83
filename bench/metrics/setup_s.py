"""setup_s: seconds from the process's start to the window's start, less
the check's copy of the rows it compares (`harness.cell`)."""


def read(ctx):
    return ctx.setup_s
