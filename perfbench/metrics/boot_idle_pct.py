"""Share of a bulk job's bootstrap batches (the span `boot.batches`,
`ops/bootstrap.py::run_replicates`) in which the card ran no kernel, copy
or set: the profiler's device intervals, merged, against the span,
averaged over the window's jobs."""

from perfbench.logs import mean
from perfbench.spans import first
from perfbench.trace import device_busy


def one(job, trace):
    batches = first(job, "boot.batches")
    if batches is None or batches.seconds <= 0:
        return None
    busy = device_busy(trace, batches.start, batches.end)
    return 100.0 * (1.0 - busy / batches.seconds)


def read(run):
    # a trace without a device event (a run on the CPU) has nothing to read
    if run.trace is None or len(run.trace.starts) == 0:
        return None
    return mean(one(job, run.trace) for job in run.jobs)
