"""Seconds a bulk job spends reading and filtering its BAM into the CSR
(`host/packer.py`, `host/native.py`, `io/bam.py`): the program's line
"Parsing of alignments from input took", averaged over the window's jobs."""

from perfbench.logs import PARSED, mean


def read(run):
    return mean(job.number(PARSED) for job in run.jobs)
