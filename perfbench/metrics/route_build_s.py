"""Seconds of the v4 route build (`ops/em_v4.py`, `ops/balance.py`,
`ops/static_permute.py`, `ops/permute_plan.py`) with the plan cache off:
from the line "em-impl auto -> v4" to "v4 routing built", on the lines'
host times, averaged over the window's jobs that built a route."""

from perfbench.logs import AUTO, ROUTING, mean


def one(job):
    built = job.find(ROUTING)
    if built is None:
        return None
    start = job.find(AUTO)
    return built[0] - start[0] if start else float(built[1].group(2))


def read(run):
    return mean(one(job) for job in run.jobs)
