"""glue_ms_per_step: device busy time per traced step outside the
``RNNCore`` calls and the optimizer's step: norms, chunking, fusion, convs,
losses, the speaker branch and autograd's own kernels."""

from benchmark.lib.trace import OPTIMIZER, RNN


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s or not ctx.units:
        return None
    rest = ctx.trace.busy_s - ctx.trace.in_range(RNN) - ctx.trace.in_range(OPTIMIZER)
    return 1e3 * rest / len(ctx.units)
