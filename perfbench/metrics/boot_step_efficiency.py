"""Share of the replicate slots' m-steps that do useful work: a batch of
bootstrap replicates (`ops/bootstrap.py::run_replicates`) runs as many
m-steps as its slowest replicate. The sum over the window's `boot.batches`
spans of `useful_steps` (each replicate's m-steps until it froze) over
the sum of `slot_steps` (each batch's size times its m-steps)."""

from perfbench.spans import spans


def read(run):
    useful = slots = 0.0
    for job in run.jobs:
        for s in spans(job, "boot.batches"):
            u, n = s.number("useful_steps"), s.number("slot_steps")
            if u is not None and n is not None:
                useful, slots = useful + u, slots + n
    return useful / slots if slots > 0 else None
