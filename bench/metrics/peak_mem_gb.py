"""peak_mem_gb: the CUDA allocator's peak over set-up and window
(`torch.cuda.max_memory_allocated()`), in GB."""


def read(ctx):
    return ctx.peak_bytes / 1e9
