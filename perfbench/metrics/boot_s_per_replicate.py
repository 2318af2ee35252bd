"""Seconds a bootstrap replicate (`ops/bootstrap.py`, the batched v4
m-step): the line "N bootstrap replicates in Ss" over N, averaged over
the window's jobs. The host's multinomial draw is inside it."""

from perfbench.logs import mean


def one(job):
    boot = job.boot()
    if boot is None or not boot[2]:
        return None
    return boot[1] / len(boot[2])


def read(run):
    return mean(one(job) for job in run.jobs)
