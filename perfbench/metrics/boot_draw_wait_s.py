"""Seconds a bulk job's bootstrap batches waited for the host's draw
(`ops/bootstrap.py::DrawStream`, the multiplicities drawn on a thread of
their own): the attribute `draw_wait_s` of the span `boot.batches`,
summed over the job's spans and averaged over the window's jobs. A
program whose batches carry no such attribute reads None."""

from perfbench.logs import mean
from perfbench.spans import spans


def one(job):
    waits = [s.number("draw_wait_s") for s in spans(job, "boot.batches")]
    waits = [w for w in waits if w is not None]
    return sum(waits) if waits else None


def read(run):
    return mean(one(job) for job in run.jobs)
