"""Seconds a single-cell job spends decoding, filtering and bucketing its
cells (`quant/single_cell.py::_iter_cells_native`, `host/native.py`):
from the job's start to the program's line `phase sc.parse`, on the
host's clock, averaged over the window's jobs. (The line's own number
starts after the BAM's decode.)"""

from perfbench.logs import SC_PHASE, mean


def one(job):
    for t, msg in job.lines:
        m = SC_PHASE.search(msg)
        if m and m.group(1) == "sc.parse":
            return t - job.start
    return None


def read(run):
    return mean(one(job) for job in run.jobs)
