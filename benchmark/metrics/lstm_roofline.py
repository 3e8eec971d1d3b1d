"""lstm_roofline: the least time the LSTM calls of the traced stretch could
take (``flops/``: per call the larger of operations over the peak and bytes
over the bandwidth) over the device time of every kernel launched inside
the ``RNNCore`` calls (the ``bench.rnn`` ranges, forward and backward)."""

from benchmark.lib.trace import RNN


def read(ctx):
    if ctx.trace is None:
        return None
    spent = ctx.trace.in_range(RNN)
    units = ctx.profiled
    if not spent or not units:
        return None
    return 100.0 * sum(u["lstm_bound_s"] for u in units) / spent
