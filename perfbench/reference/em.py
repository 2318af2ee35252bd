"""oarfish's EM (`em.rs:144-255`) in plain PyTorch, for one sample, a
batch of bootstrap replicates, or every cell of a single-cell library.

An m-step gives each alignment `prev[t] * w`, divides it by its read's
sum (a read whose sum is at most 1e-30 is dropped) times the read's
multiplicity, and adds the results up per transcript. The loop stops
after the first m-step whose largest relative rise over the transcripts
above 1e-5 is under the threshold, counted only once more than 50
m-steps have run, or after `max_iter` m-steps; then abundances under 1e-5
are zeroed and one last m-step gives the counts. A batch (replicates, or
cells) freezes each member at its own stopping point.

The sums use `index_add_`, so on the card their order is not fixed; in
float64 that moves the last bits only.
"""

from __future__ import annotations

import numpy as np
import torch

MIN_READ_THRESH = 1e-5
EM_DENOM_THRESH = 1e-30


class Csr:
    """The kept alignments of G independent groups (one sample, or one
    group per cell), as flat device arrays: alignment -> transcript slot
    and read, slot -> group, read -> group."""

    def __init__(self, slot, w, read, num_reads, num_slots, group_of_slot,
                 num_groups, device, dtype):
        as_i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                           device=device)
        self.slot = as_i64(slot)
        self.read = as_i64(read)
        self.w = torch.as_tensor(np.asarray(w, np.float64),
                                 device=device).to(dtype)
        self.num_reads, self.num_slots = num_reads, num_slots
        self.group_of_slot = as_i64(group_of_slot)
        self.num_groups = num_groups
        # a group with no slot (a cell whose reads were all dropped) has
        # nothing to run
        self.empty = torch.as_tensor(
            np.bincount(np.asarray(group_of_slot, np.int64),
                        minlength=num_groups) == 0, device=device)
        self.dtype, self.device = dtype, device

    def m_step(self, prev, mult=None):
        """`prev` [B, num_slots] -> [B, num_slots]; `mult` [B, num_reads]
        or None (every read once)."""
        B = prev.shape[0]
        contrib = prev.index_select(1, self.slot) * self.w
        denom = torch.zeros(B, self.num_reads, dtype=self.dtype,
                            device=self.device).index_add_(1, self.read,
                                                           contrib)
        num = 1.0 if mult is None else mult
        scale = torch.where(denom > EM_DENOM_THRESH, num / denom,
                            torch.zeros((), dtype=self.dtype,
                                        device=self.device))
        inc = contrib * scale.index_select(1, self.read)
        return torch.zeros(B, self.num_slots, dtype=self.dtype,
                           device=self.device).index_add_(1, self.slot, inc)

    def rel_rise(self, prev, curr):
        """[B, num_groups]: each group's largest relative rise over its
        slots above MIN_READ_THRESH, at least 0."""
        mask = prev > MIN_READ_THRESH
        rd = torch.where(mask, (curr - prev) / torch.where(mask, prev, 1.0),
                         torch.zeros((), dtype=self.dtype,
                                     device=self.device))
        out = torch.zeros(prev.shape[0], self.num_groups, dtype=self.dtype,
                          device=self.device)
        idx = self.group_of_slot.expand(prev.shape[0], -1)
        return out.scatter_reduce_(1, idx, rd, "amax", include_self=True)


def run_em(csr: Csr, init, mult=None, max_iter=1000, thresh=1e-3,
           min_iters=50):
    """The EM from `init` [B, num_slots]; returns (counts [B, num_slots],
    m-steps [B, num_groups])."""
    prev = init.clone()
    B = prev.shape[0]
    niter = torch.zeros(B, csr.num_groups, dtype=torch.int64,
                        device=csr.device)
    conv = csr.empty.expand(B, -1).clone()
    for step in range(max_iter):
        if step > min_iters and bool(conv.all()):
            break
        curr = csr.m_step(prev, mult)
        newly = (csr.rel_rise(prev, curr) < thresh) & (niter > min_iters)
        frozen = conv.index_select(1, csr.group_of_slot)
        prev = torch.where(frozen, prev, curr)
        niter = torch.where(conv, niter, niter + 1)
        conv = conv | newly
    prev = torch.where(prev < MIN_READ_THRESH, 0.0, prev)
    return csr.m_step(prev, mult), niter


def bulk_csr(kept, num_txps, device, dtype):
    """One sample's kept alignments as a `Csr` of one group."""
    return Csr(kept.txp_id, kept.prob.astype(np.float64),
               np.repeat(np.arange(kept.num_reads),
                         np.diff(kept.read_offsets)),
               kept.num_reads, num_txps, np.zeros(num_txps, np.int64), 1,
               device, dtype)


def bootstrap_multiplicities(num_reads: int, num_boot: int,
                             seed: int) -> np.ndarray:
    """[num_boot, R] read multiplicities of oarfish's bootstrap: R reads
    drawn uniformly with replacement per replicate, as one multinomial
    row each from NumPy's default generator seeded with the CLI's
    `--seed`."""
    rng = np.random.default_rng(seed)
    return rng.multinomial(num_reads, np.full(num_reads, 1.0 / num_reads),
                           size=num_boot)


def cells_csr(kept, cell_of_read: np.ndarray, num_cells: int, num_txps: int,
              device, dtype):
    """Every cell of a single-cell library as one `Csr`, each cell's
    transcripts relabelled to slots of its own. `cell_of_read` gives the
    cell of each read of the BAM (file order). Returns (csr, the global
    transcript of each slot, the cell of each slot, the kept reads of
    each cell)."""
    read_of_aln = np.repeat(np.arange(kept.num_reads),
                            np.diff(kept.read_offsets))
    cell_of_aln = cell_of_read[kept.read_of_record]
    uniq, slot = np.unique(cell_of_aln * num_txps + kept.txp_id,
                           return_inverse=True)
    cell_of_slot = uniq // num_txps
    txp_of_slot = uniq % num_txps
    kept_reads = np.bincount(
        cell_of_read[kept.read_of_record[kept.read_offsets[:-1]]],
        minlength=num_cells)
    csr = Csr(slot, kept.prob.astype(np.float64), read_of_aln,
              kept.num_reads, len(uniq), cell_of_slot, num_cells, device,
              dtype)
    return csr, txp_of_slot, cell_of_slot, kept_reads
