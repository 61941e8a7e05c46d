"""Share of the traced stretch in which no kernel, copy or set ran on the
device, from the profiler's device intervals."""


def read(ctx):
    trace, window_s = ctx.trace, ctx.record["trace_window_s"]
    if trace is None or not window_s or trace["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_us"] * 1e-6 / window_s)
