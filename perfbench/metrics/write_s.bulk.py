"""Seconds a bulk job spends in its writers (`quant/writers.py`): the
spans `bulk.write.*` (the quantification, the bootstrap replicates, the
assignment probabilities) summed per job, averaged over the window's
jobs."""

from perfbench.logs import mean
from perfbench.spans import spans


def one(job):
    found = spans(job, prefix="bulk.write.")
    return sum(s.seconds for s in found) if found else None


def read(run):
    return mean(one(job) for job in run.jobs)
