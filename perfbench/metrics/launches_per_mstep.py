"""Kernels the card runs per m-step of a bulk job's point EM: the device
trace's kernels (the hand-written ones and torch's own) that start inside
the span `bulk.em`, over its `msteps`, averaged over the window's
jobs."""

from perfbench.logs import mean
from perfbench.spans import first, kernels_starting


def one(job, trace):
    em = first(job, "bulk.em")
    steps = None if em is None else em.number("msteps")
    if not steps:
        return None
    return kernels_starting(trace, em.start, em.end) / steps


def read(run):
    # a trace without a device event (a run on the CPU) has nothing to read
    if run.trace is None or len(run.trace.starts) == 0:
        return None
    return mean(one(job, run.trace) for job in run.jobs)
