"""Peaks of the card and the least bytes that the EM's work needs.

The bytes are counted from the problem (alignments, reads, transcripts,
and the m-steps each replicate ran), never from the program's layouts,
so a later redesign of the kernels cannot make the count stale.
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM (80GB HBM3) data sheet, at its 700 W limit
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
}

VALUE = 4  # an f32 weight, abundance or multiplicity
INDEX = 4  # an i32 transcript id or read offset


def csr_bytes(alignments: int, reads: int) -> int:
    """One pass over the CSR: each alignment's weight and transcript id,
    each read's offset."""
    return alignments * (VALUE + INDEX) + (reads + 1) * INDEX


def em_least_bytes(alignments: int, reads: int, transcripts: int,
                   point_steps: int, replicate_steps: Sequence[int]) -> int:
    """The least HBM bytes of a job's EM work: the CSR once per m-step
    that any replicate still runs, each replicate's multiplicities and
    abundances (read and written) once per m-step of its own, and the
    point EM's m-steps on top (the CSR and the abundances each)."""
    csr = csr_bytes(alignments, reads)
    abund = 2 * transcripts * VALUE
    total = point_steps * (csr + abund)
    if len(replicate_steps):
        total += max(replicate_steps) * csr
        total += sum(replicate_steps) * (reads * VALUE + abund)
    return total
