"""Milliseconds an m-step of a bulk job's point EM (`ops/em.py`,
`ops/em_v4.py`): the seconds over the iterations of the line "EM on ...
converged after N iterations in Ss", averaged over the window's jobs."""

from perfbench.logs import EM, mean


def one(job):
    hit = job.find(EM)
    if hit is None or int(hit[1].group(2)) == 0:
        return None
    return 1000.0 * float(hit[1].group(3)) / int(hit[1].group(2))


def read(run):
    return mean(one(job) for job in run.jobs)
