"""optimizer_ms_per_step: device time per traced step of the kernels
launched inside the trainer's ``optimizer.step`` (clip + Adam)."""

from benchmark.lib.trace import OPTIMIZER


def read(ctx):
    if ctx.trace is None or not ctx.units or not ctx.trace.has_range(OPTIMIZER):
        return None
    spent = ctx.trace.in_range(OPTIMIZER)
    return 1e3 * spent / len(ctx.units) if spent else None
