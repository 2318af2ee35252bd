"""Projection of genomic (spliced) alignments onto transcript models, and
the projected-alignment filter.

This is the from-scratch equivalent of the external `bramble-rs`
projection engine the reference drives (`project_group_with` at
`bulk.rs:521` / `alignment_parser.rs:564`) together with an exact
reimplementation of `AlignmentFilters::filter_projected`
(`oarfish_types.rs:1179-1297`).

Semantics of the projection (clean-room design, guided by the reference's
documented behavior):

* A genomic alignment is decomposed by CIGAR walk into aligned match
  blocks (M/=/X), insertions, and introns (N).
* For every transcript whose exonic extent overlaps the aligned span, the
  exonic-coverage similarity is the fraction of the read's aligned bases
  that land inside the transcript's exons, discounted by
  `junc_miss_discount` for every alignment intron that does not match a
  transcript splice junction (`--junc-miss-discount`,
  `prog_opts.rs:399-403`).
* Transcript-space start/end come from mapping the first/last
  exonic-overlapping genomic base through the exon chain (reverse-strand
  transcripts flip the coordinate).
* `is_reverse` = read strand XOR transcript strand.

Counterpart of the JAX package's `genome/project.py` (host code, kept as a copy so this
package stands alone).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import FilterOpts, ProjProbSource, Strand
from .g2t import G2TIndex

F32_MIN_EXP = -87.0  # below this exp() underflows f32 anyway


@dataclass
class GenomicAlignment:
    """One spliced genome-space alignment record (subset of the reference's
    `GenomicAlignment`, `alignment_parser.rs:484-524`)."""

    ref_id: int
    ref_start: int  # 1-based (SAM POS)
    is_reverse: bool
    cigar: List[Tuple[int, int]]  # (len, op) BAM op codes
    read_len: int
    score: int = 0  # AS tag of the source alignment
    sequence: Optional[bytes] = None


@dataclass
class ProjectedAlnRecord:
    """Neutral projection hand-off (`oarfish_types.rs:1142-1164`)."""

    ref_id: int
    start: int  # 1-based
    end: int  # 1-based inclusive
    aligned_len: int
    query_aligned_len: int
    is_reverse: bool
    similarity: float
    aln_score: int


def _walk_cigar(aln: GenomicAlignment):
    """Returns (match_blocks [(gs, ge)] 1-based inclusive, introns
    [(gs, ge)], total_query_aligned (M/I/=/X bases))."""
    g = aln.ref_start
    blocks: List[Tuple[int, int]] = []
    introns: List[Tuple[int, int]] = []
    q_aligned = 0
    for length, op in aln.cigar:
        if op in (0, 7, 8):  # M / = / X
            blocks.append((g, g + length - 1))
            q_aligned += length
            g += length
        elif op == 1:  # I
            q_aligned += length
        elif op == 2:  # D
            g += length
        elif op == 3:  # N
            introns.append((g, g + length - 1))
            g += length
        # S/H/P consume no reference
    return blocks, introns, q_aligned


def project_alignment(
    aln: GenomicAlignment,
    g2t: G2TIndex,
    junc_miss_discount: float = 1.0,
    rescue_db=None,
) -> List[ProjectedAlnRecord]:
    """Project one genomic alignment onto all candidate transcripts."""
    blocks, introns, q_aligned = _walk_cigar(aln)
    clips = None
    if rescue_db is not None and aln.sequence:
        # leading/trailing soft-clip lengths from the CIGAR (BAM SEQ is
        # already reference-forward, so no strand handling needed)
        c5 = aln.cigar[0][0] if aln.cigar and aln.cigar[0][1] == 4 else 0
        c3 = aln.cigar[-1][0] if aln.cigar and aln.cigar[-1][1] == 4 else 0
        if c5 or c3:
            seq = aln.sequence.upper()
            clips = (
                seq[:c5] if c5 else b"",
                seq[len(seq) - c3 :] if c3 else b"",
            )
    return project_blocks(
        aln.ref_id, blocks, introns, q_aligned, aln.is_reverse, aln.score,
        g2t, junc_miss_discount,
        rescue=(rescue_db, *clips) if clips else None,
    )


def project_blocks(
    ref_id: int,
    blocks: List[Tuple[int, int]],
    introns: List[Tuple[int, int]],
    q_aligned: int,
    is_reverse: bool,
    score: int,
    g2t: G2TIndex,
    junc_miss_discount: float = 1.0,
    junction_tolerance: int = 0,
    rescue=None,
) -> List[ProjectedAlnRecord]:
    """Project aligned genomic blocks (1-based inclusive) + introns onto
    all candidate transcripts. This is the shared core for both the
    CIGAR path (genome BAM, base-accurate, tolerance 0) and the
    spliced-mapper path (genome reads, anchor-resolution block edges, so
    junction matching allows `junction_tolerance` bases of slack).

    `rescue` is an optional `(RescueDb, clip_left, clip_right)` triple
    (sequences in genome-forward orientation): clipped read ends are
    x-drop-extended against each candidate's neighboring exon sequence,
    adding recovered bases to the exonic match (and the capped clip
    lengths to the denominator, so isoforms that explain the clip win)."""
    if not blocks or q_aligned == 0:
        return []
    q_den = q_aligned
    if rescue is not None:
        from .rescue import CLIP_CAP

        _db, _cl, _cr = rescue
        q_den += min(len(_cl), CLIP_CAP) + min(len(_cr), CLIP_CAP)
    gstart = blocks[0][0]
    gend = blocks[-1][1]
    out: List[ProjectedAlnRecord] = []
    for tid in g2t.candidates(ref_id, gstart, gend):
        m = g2t.models[tid]
        es, ee = m.exon_starts, m.exon_ends
        # exonic overlap of the match blocks
        matched = 0
        first_g: Optional[int] = None
        last_g: Optional[int] = None
        for bs, be in blocks:
            lo = int(np.searchsorted(ee, bs, side="left"))
            for i in range(lo, len(es)):
                s, e = int(es[i]), int(ee[i])
                if s > be:
                    break
                o_s = max(bs, s)
                o_e = min(be, e)
                if o_s <= o_e:
                    matched += o_e - o_s + 1
                    if first_g is None:
                        first_g = o_s
                    last_g = o_e
        if matched == 0 or first_g is None:
            continue

        # junction consistency: each alignment intron inside the transcript
        # span must coincide with a transcript intron (exon_end == gs-1 and
        # next exon_start == ge+1)
        n_mismatch = 0
        span_s, span_e = m.span()
        tol = junction_tolerance
        for gs, ge in introns:
            if ge < span_s or gs > span_e:
                continue
            i = int(np.searchsorted(ee, gs - 1 - tol, side="left"))
            ok = False
            for j in (i, i + 1):
                if 0 <= j < len(ee) - 1 and (
                    abs(int(ee[j]) - (gs - 1)) <= tol
                    and abs(int(es[j + 1]) - (ge + 1)) <= tol
                ):
                    ok = True
                    break
            if not ok:
                n_mismatch += 1

        rl = rr = 0
        if rescue is not None:
            from .rescue import rescue_clips

            db, clip_l, clip_r = rescue
            rl, rr = rescue_clips(db, m, first_g, last_g, clip_l, clip_r)
            matched += rl + rr

        t1 = m.to_txp_coord(first_g)
        t2 = m.to_txp_coord(last_g)
        if t1 is None or t2 is None:
            continue
        start, end = (t1, t2) if t1 <= t2 else (t2, t1)
        if rl or rr:
            # extend transcript coordinates by the rescued bases; the
            # genome-left clip extends the transcript start on '+' strand
            # and the end on '-' strand
            if m.strand == "-":
                start -= rr
                end += rl
            else:
                start -= rl
                end += rr
            start = max(start, 1)
            end = min(end, m.length)

        # similarity denominator: the aligned query span OR the projected
        # transcript span, whichever is larger. The span term charges
        # internal transcript sequence the alignment skips (an intron
        # spanning a retained exon), so a junction-spanning read
        # discriminates against the intron-retaining isoform — without
        # it, both isoforms of a skipped-exon pair score 1.0 and the EM
        # collapses the pair (genome_vs_txome_eval: 2436/2552
        # both-expressed genes collapsed; with the span term the genome
        # mode tracks direct transcriptome quantification, the
        # reference's README.md:229 claim).
        similarity = matched / max(q_den, end - start + 1)
        if junc_miss_discount < 1.0 and n_mismatch:
            similarity *= junc_miss_discount**n_mismatch
        out.append(
            ProjectedAlnRecord(
                ref_id=tid,
                start=int(start),
                end=int(end),
                aligned_len=int(end - start + 1),
                query_aligned_len=int(matched),
                is_reverse=bool(is_reverse ^ (m.strand == "-")),
                similarity=float(similarity),
                aln_score=int(score),
            )
        )
    return out


def project_group(
    alns: Sequence[GenomicAlignment],
    g2t: G2TIndex,
    junc_miss_discount: float = 1.0,
    rescue_db=None,
) -> List[ProjectedAlnRecord]:
    """Project a read's alignment group; when several source alignments hit
    the same transcript, the highest-similarity projection wins."""
    best: dict = {}
    for a in alns:
        for rec in project_alignment(a, g2t, junc_miss_discount, rescue_db):
            prev = best.get(rec.ref_id)
            if prev is None or rec.similarity > prev.similarity:
                best[rec.ref_id] = rec
    return list(best.values())


def filter_projected(
    opts: FilterOpts,
    discard,
    txp_len: np.ndarray,
    recs: Sequence[ProjectedAlnRecord],
    read_len: int,
    beta: float,
    prob_source: ProjProbSource,
):
    """Exact port of `AlignmentFilters::filter_projected`
    (`oarfish_types.rs:1179-1297`). Returns a `FilteredGroup` or None."""
    from ..host.filters import FilteredGroup

    best_sim = -np.inf
    best_score = -(1 << 31)
    frac_at_best = np.float32(0.0)
    kept: List[ProjectedAlnRecord] = []

    for r in recs:
        if opts.which_strand == Strand.REVERSE and not r.is_reverse:
            discard.discard_ori += 1
            continue
        if opts.which_strand == Strand.FORWARD and r.is_reverse:
            discard.discard_ori += 1
            continue
        if r.aligned_len < opts.min_aligned_len:
            discard.discard_aln_len += 1
            continue
        tl = int(txp_len[r.ref_id])
        if r.end <= tl - opts.three_prime_clip:
            discard.discard_3p += 1
            continue
        if r.start >= opts.five_prime_clip:
            discard.discard_5p += 1
            continue
        if r.similarity > best_sim:
            best_sim = r.similarity
            frac_at_best = (
                np.float32(r.query_aligned_len) / np.float32(read_len)
                if read_len > 0
                else np.float32(0.0)
            )
        if r.aln_score > best_score:
            best_score = r.aln_score
        kept.append(r)

    if not kept or best_sim <= 0.0:
        return None
    if frac_at_best < np.float32(opts.min_aligned_fraction):
        discard.discard_aln_frac += 1
        return None
    discard.valid_best_aln += 1

    inv_msim = 1.0 / best_sim
    txp, start, end, prob, is_rev = [], [], [], [], []
    for r in kept:
        if np.float32(r.similarity * inv_msim) < np.float32(opts.score_threshold):
            discard.discard_score += 1
            continue
        tl = int(txp_len[r.ref_id])
        s = min(max(r.start, 1), tl)
        e = min(max(r.end, s), tl)
        if prob_source == ProjProbSource.SIMILARITY:
            f = np.float32(r.similarity - best_sim) * np.float32(beta)
        elif prob_source == ProjProbSource.SCORE:
            f = np.float32(r.aln_score - best_score) / np.float32(
                opts.score_prob_denom
            )
        else:
            f = np.float32(r.aln_score - best_score) / np.float32(
                opts.score_prob_denom
            ) + np.float32(beta) * np.float32(r.similarity - best_sim)
        txp.append(r.ref_id)
        start.append(s)
        end.append(e)
        prob.append(np.exp(np.float32(f)))
        is_rev.append(r.is_reverse)

    return FilteredGroup(
        txp_id=np.asarray(txp, dtype=np.int32),
        start=np.asarray(start, dtype=np.int64),
        end=np.asarray(end, dtype=np.int64),
        prob=np.asarray(prob, dtype=np.float32),
        is_reverse=np.asarray(is_rev, dtype=bool),
    )


def filter_projected_batch(
    opts: FilterOpts,
    discard,
    txp_len: np.ndarray,
    roff: np.ndarray,        # int64 [R+1] candidate offsets per read
    tid: np.ndarray,         # int32/int64 [C] (dedup'd, segment-ordered)
    pstart: np.ndarray,      # int64 [C]
    pend: np.ndarray,        # int64 [C]
    matched: np.ndarray,     # int64 [C] query_aligned_len
    sim: np.ndarray,         # f64 [C]
    score: np.ndarray,       # int64 [C]
    is_rev: np.ndarray,      # bool [C]
    read_len: np.ndarray,    # int64 [R]
    beta: float,
    prob_source: ProjProbSource,
):
    """Vectorized `filter_projected` over a whole mapped batch (the
    per-read loop built ~80k ProjectedAlnRecord lists per GENCODE batch
    = most of the map-phase wall; round 5). Semantics are the exact
    reference port in `filter_projected` above, applied per `roff`
    segment — differential-tested against it in
    tests/test_genome_mode.py. Returns (keep_mask [C] bool,
    prob [C] f32, read_ok [R] bool) where keep_mask selects the
    surviving candidates in segment order and read_ok marks reads that
    pass the group-level checks (best_sim > 0, aligned fraction)."""
    C = len(tid)
    R = len(roff) - 1
    if C == 0:
        return (np.zeros(0, dtype=bool), np.zeros(0, dtype=np.float32),
                np.zeros(R, dtype=bool))
    rid = np.repeat(np.arange(R), np.diff(roff))
    tl = txp_len[tid]

    kept = np.ones(C, dtype=bool)
    if opts.which_strand == Strand.REVERSE:
        bad = ~is_rev
        discard.discard_ori += int(bad.sum())
        kept &= ~bad
    elif opts.which_strand == Strand.FORWARD:
        bad = is_rev
        discard.discard_ori += int(bad.sum())
        kept &= ~bad
    aligned_len = pend - pstart + 1
    bad = kept & (aligned_len < opts.min_aligned_len)
    discard.discard_aln_len += int(bad.sum())
    kept &= ~bad
    bad = kept & (pend <= tl - opts.three_prime_clip)
    discard.discard_3p += int(bad.sum())
    kept &= ~bad
    bad = kept & (pstart >= opts.five_prime_clip)
    discard.discard_5p += int(bad.sum())
    kept &= ~bad
    kept_basic = kept.copy()  # best_score is over pass-1 survivors

    # group stats over kept candidates (reference iteration order ==
    # segment order; "strictly greater" update == first argmax)
    siml = np.where(kept, sim, -np.inf)
    if C and np.all(np.diff(roff) > 0):
        best_sim = np.maximum.reduceat(siml, roff[:-1])
    else:
        best_sim = np.full(R, -np.inf)
        np.maximum.at(best_sim, rid, siml)
    is_best = kept & (siml == best_sim[rid])
    pos = np.where(is_best, np.arange(C), C)
    if C and np.all(np.diff(roff) > 0):
        first_best = np.minimum.reduceat(pos, roff[:-1])
    else:
        first_best = np.full(R, C, dtype=np.int64)
        np.minimum.at(first_best, rid, pos)
    has_kept = first_best < C
    fb = np.minimum(first_best, max(C - 1, 0))
    frac_at_best = np.where(
        read_len > 0,
        matched[fb].astype(np.float32)
        / np.maximum(read_len, 1).astype(np.float32),
        np.float32(0.0),
    ).astype(np.float32)

    read_ok = has_kept & (best_sim > 0.0)
    frac_fail = read_ok & (
        frac_at_best < np.float32(opts.min_aligned_fraction)
    )
    discard.discard_aln_frac += int(frac_fail.sum())
    read_ok &= ~frac_fail
    discard.valid_best_aln += int(read_ok.sum())

    kept &= read_ok[rid]
    # similarity-ratio threshold (f32 compare, as the reference)
    inv_msim = np.where(best_sim > 0, 1.0 / best_sim, 0.0)
    ratio_fail = kept & (
        (sim * inv_msim[rid]).astype(np.float32)
        < np.float32(opts.score_threshold)
    )
    discard.discard_score += int(ratio_fail.sum())
    kept &= ~ratio_fail

    # probabilities (f32, per prob source)
    if prob_source == ProjProbSource.SIMILARITY:
        f = (sim - best_sim[rid]).astype(np.float32) * np.float32(beta)
    else:
        scl = np.where(kept_basic, score, np.iinfo(np.int64).min)
        if C and np.all(np.diff(roff) > 0):
            best_score = np.maximum.reduceat(scl, roff[:-1])
        else:
            best_score = np.full(R, np.iinfo(np.int64).min)
            np.maximum.at(best_score, rid, scl)
        f = (score - best_score[rid]).astype(np.float32) / np.float32(
            opts.score_prob_denom
        )
        if prob_source != ProjProbSource.SCORE:
            f = f + np.float32(beta) * (
                sim - best_sim[rid]
            ).astype(np.float32)
    prob = np.exp(f.astype(np.float32)).astype(np.float32)
    return kept, prob, read_ok
