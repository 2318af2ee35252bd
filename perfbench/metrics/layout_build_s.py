"""Seconds of the host half of the v4 route build (`ops/em_v4.py::
_v4_layout`: buckets, slots and the balance passes, before the route
tables): the span `v4.layout`, summed per job, averaged over the window's
jobs that built a route."""

from perfbench.logs import mean
from perfbench.spans import spans


def one(job):
    found = spans(job, "v4.layout")
    return sum(s.seconds for s in found) if found else None


def read(run):
    return mean(one(job) for job in run.jobs)
