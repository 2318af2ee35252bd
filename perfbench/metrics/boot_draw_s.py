"""Seconds of a bulk job's bootstrap draw on the host
(`ops/bootstrap.py::sample_multiplicities`, the permutation into the
layout's read order and the change of dtype): the span `boot.draw`,
averaged over the window's jobs."""

from perfbench.logs import mean
from perfbench.spans import first


def one(job):
    draw = first(job, "boot.draw")
    return None if draw is None else draw.seconds


def read(run):
    return mean(one(job) for job in run.jobs)
