"""Share of the traced window in which the card ran no kernel, copy or
set: the profiler's device intervals, merged, against the window."""

from perfbench.trace import device_busy


def read(run):
    trace = run.trace
    if trace is None or trace.window_s <= 0:
        return None
    lo, hi = trace.window
    return 100.0 * (1.0 - device_busy(trace, lo, hi) / trace.window_s)
