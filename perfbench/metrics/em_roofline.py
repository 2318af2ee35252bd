"""Share of the HBM roofline that a bulk job's EM work reaches: the least
bytes that its point EM and replicates need (`perfbench/roofline.py`,
counted from the CSR's sizes and the m-steps that the program's log
lines report) at 3.35 TB/s, over the device time of the kernels from the
EM's start (the line "v4 routing built") to the end of the bootstrap,
summed over the window's jobs."""

from perfbench.logs import EM, READS, RECORDS, ROUTING, TXPS
from perfbench.roofline import PEAKS, em_least_bytes
from perfbench.trace import device_busy


def one(job, trace):
    start, em = job.find(ROUTING), job.find(EM)
    sizes = [job.number(p) for p in (RECORDS, READS, TXPS)]
    if start is None or em is None or None in sizes:
        return None
    boot = job.boot()
    end = boot[0] if boot else em[0]
    steps = [i + 1 for i in boot[2]] if boot else []
    least = em_least_bytes(int(sizes[0]), int(sizes[1]), int(sizes[2]),
                           int(em[1].group(2)) + 1, steps)
    busy = device_busy(trace, start[0], end, kernels_only=True)
    return least / PEAKS["hbm_bytes_per_s"], busy


def read(run):
    if run.trace is None:
        return None
    parts = [p for p in (one(job, run.trace) for job in run.jobs) if p]
    busy = sum(b for _, b in parts)
    if not parts or busy <= 0:
        return None
    return 100.0 * sum(t for t, _ in parts) / busy
