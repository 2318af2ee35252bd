"""The alignment filters of oarfish's transcriptome-BAM mode
(`AlignmentFilters::filter`, `oarfish_types.rs:955-1130`) at the CLI's
default settings, over the generated records of one BAM.

Every record is mapped, forward and not supplementary (the generator
makes no others). A read's records are checked in file order: a record
is retained when its reference span is at least `min_aligned_len` and
neither clip rule drops it; the first retained record with the highest
score gives the read's best score and its aligned fraction (span over
the primary's SEQ length, in float32). A read is kept when it has a
retained record, a best score above 0 and an aligned fraction of at
least `min_aligned_fraction`; of a kept read's retained records those
with `score / best >= score_threshold` (float32) are kept, each with the
probability `exp((score - best) / score_prob_denom)` in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

U32_MAX = 2**32 - 1


@dataclass(frozen=True)
class FilterSettings:
    score_threshold: float = 0.95
    min_aligned_fraction: float = 0.5
    min_aligned_len: int = 50
    three_prime_clip: int = U32_MAX
    five_prime_clip: int = U32_MAX
    score_prob_denom: float = 5.0


@dataclass
class Kept:
    """The CSR of the kept alignments, reads in file order."""

    txp_id: np.ndarray  # int64 [A]
    prob: np.ndarray  # float32 [A]
    read_offsets: np.ndarray  # int64 [R + 1]
    read_of_record: np.ndarray  # int64 [A]: the read (file order) of each
    reads_in: int  # reads in the BAM
    valid_best_aln: int  # reads kept
    discard_score: int  # retained records of kept reads under the threshold

    @property
    def num_reads(self) -> int:
        return len(self.read_offsets) - 1


def filter_records(rec, settings: FilterSettings = FilterSettings()) -> Kept:
    """`rec`: the generator's arrays (`sizes`, `seq_len`, `tid`, `pos`,
    `span`, `score`, `t_len`)."""
    sizes = np.asarray(rec["sizes"], dtype=np.int64)
    G = len(sizes)
    gid = np.repeat(np.arange(G, dtype=np.int64), sizes)
    tid = np.asarray(rec["tid"], dtype=np.int64)
    span = np.asarray(rec["span"], dtype=np.int64)
    pos = np.asarray(rec["pos"], dtype=np.int64)
    score = np.asarray(rec["score"], dtype=np.int64)
    t_len = np.asarray(rec["t_len"], dtype=np.int64)
    aln_start = pos + 1  # 1-based
    aln_end = pos + span  # 1-based, inclusive

    retained = (
        (span >= settings.min_aligned_len)
        & ~(aln_end <= t_len[tid] - settings.three_prime_clip)
        & ~(aln_start >= settings.five_prime_clip)
    )
    i32_min = np.int64(-(2**31))
    s_ret = np.where(retained, score, i32_min)
    best = np.full(G, i32_min, dtype=np.int64)
    np.maximum.at(best, gid, s_ret)
    # the first retained record that reaches the best score
    is_best = retained & (score == best[gid])
    first_best = np.full(G, -1, dtype=np.int64)
    idx = np.nonzero(is_best)[0]
    first_best[gid[idx][::-1]] = idx[::-1]
    has_best = first_best >= 0
    span_at_best = np.where(has_best, span[np.maximum(first_best, 0)], 0)
    seq_len = np.asarray(rec["seq_len"], dtype=np.int64)
    frac = np.where(
        (seq_len > 0) & has_best,
        span_at_best.astype(np.float32)
        / np.where(seq_len > 0, seq_len, 1).astype(np.float32),
        np.float32(0.0)).astype(np.float32)
    n_ret = np.bincount(gid, weights=retained, minlength=G)
    dead = (n_ret == 0) | (span_at_best == 0) | (best <= 0)
    live = ~dead & (frac >= np.float32(settings.min_aligned_fraction))

    cand = retained & live[gid]
    mscore = best[gid].astype(np.float32)
    fscore = score.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        ok = cand & ((fscore * (np.float32(1.0) / mscore))
                     >= np.float32(settings.score_threshold))
    keep = np.nonzero(ok)[0]
    prob = np.exp((fscore[keep] - mscore[keep])
                  / np.float32(settings.score_prob_denom)).astype(np.float32)
    per_read = np.bincount(gid[keep], minlength=G)
    emitted = per_read > 0
    offsets = np.zeros(int(emitted.sum()) + 1, dtype=np.int64)
    np.cumsum(per_read[emitted], out=offsets[1:])
    return Kept(
        txp_id=tid[keep], prob=prob, read_offsets=offsets,
        read_of_record=gid[keep], reads_in=G,
        valid_best_aln=int(live.sum()),
        discard_score=int((cand & ~ok).sum()),
    )


def aux_counts(kept: Kept, num_txps: int):
    """Per transcript: kept records of reads with one kept record
    (`unique`) and all kept records (`total`), as `.ambig_info.tsv` has
    them."""
    total = np.bincount(kept.txp_id, minlength=num_txps)
    one = np.diff(kept.read_offsets) == 1
    unique = np.bincount(kept.txp_id[kept.read_offsets[:-1][one]],
                         minlength=num_txps)
    return unique.astype(np.int64), total.astype(np.int64)
