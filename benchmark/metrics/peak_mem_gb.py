"""peak_mem_gb: ``torch.cuda.max_memory_allocated`` over the window, reset at
its start, in 10^9 bytes."""


def read(ctx):
    peak = ctx.stats.get("memory_peak_bytes")
    return peak / 1e9 if peak else None
