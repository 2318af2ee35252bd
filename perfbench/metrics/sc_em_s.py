"""Seconds of a single-cell job's per-cell EMs over its size buckets
(`quant/single_cell.py`, `ops/em_dense.py`): the program's line
`phase sc.em`, averaged over the window's jobs."""

from perfbench.logs import mean, sc_phase


def read(run):
    return mean(sc_phase(job, "sc.em") for job in run.jobs)
