"""Soft-clip rescue: re-align clipped read ends against a transcript's
neighboring exon sequence to recover discriminating bases.

Equivalent of bramble's default-on rescue (reference `main.rs:291-295`,
`projection.rs:238-273`, `--no-rescue` at `prog_opts.rs:359-364`): when a
read's genomic alignment is soft-clipped at a splice boundary, the clip
may continue into the *next exon* of the true isoform; extending it
against each candidate transcript's exon chain discriminates isoforms
that share the aligned exons. The reference notes rescue measurably
improves isoform accuracy (`README.md:229`).

Implementation: x-drop extension (match +1, mismatch -2, drop 6) of the
clip sequence against the transcript's exonic context walked outward from
the alignment's genomic boundary — all in genome-forward orientation, so
BAM SEQ (already reference-forward) needs no strand handling; genome-read
mode reverse-complements reverse-strand mappings first
(`projection.rs:295-307`).

Counterpart of the JAX package's `genome/rescue.py` (host code, kept as a copy so this
package stands alone).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.fasta import iter_fastx
from .g2t import G2TIndex, TxModel

CLIP_CAP = 200
XDROP = 6
MIN_CLIP = 3


def extend_match(a: bytes, b: bytes, xdrop: int = XDROP) -> int:
    """Bases matched through the best-scoring prefix of an x-drop
    extension of `a` against `b` (+1 match / -2 mismatch)."""
    score = best = 0
    best_len = 0
    n = min(len(a), len(b))
    for i in range(n):
        score += 1 if a[i] == b[i] else -2
        if score > best:
            best = score
            best_len = i + 1
        if best - score > xdrop:
            break
    return best_len


class RescueDb:
    """Genome sequences + per-transcript exonic context extraction."""

    def __init__(self, chrom_seqs: Dict[str, bytes], refnames: List[str]):
        self.seqs: List[Optional[bytes]] = [
            chrom_seqs.get(name) for name in refnames
        ]

    @classmethod
    def from_fasta(cls, path, refnames: List[str]) -> "RescueDb":
        seqs = {name: seq.upper() for name, seq in iter_fastx(path)}
        return cls(seqs, refnames)

    def left_context(self, m: TxModel, g: int, cap: int = CLIP_CAP) -> bytes:
        """Exonic bases of transcript `m` immediately LEFT of genomic
        position `g` (1-based), reading right-to-left (reversed), skipping
        introns."""
        chrom = self.seqs[m.chrom_id] if 0 <= m.chrom_id < len(self.seqs) else None
        if chrom is None:
            return b""
        out = bytearray()
        i = int(np.searchsorted(m.exon_starts, g, side="right")) - 1
        pos = g - 1  # rightmost base to include (1-based)
        while i >= 0 and len(out) < cap:
            s, e = int(m.exon_starts[i]), int(m.exon_ends[i])
            hi = min(pos, e)
            if hi >= s:
                chunk = chrom[s - 1 : hi]  # 1-based inclusive -> bytes
                out.extend(chunk[::-1])
            i -= 1
            if i >= 0:
                pos = int(m.exon_ends[i])
        return bytes(out[:cap])

    def right_context(self, m: TxModel, g: int, cap: int = CLIP_CAP) -> bytes:
        """Exonic bases of transcript `m` immediately RIGHT of genomic
        position `g` (1-based), forward order, skipping introns."""
        chrom = self.seqs[m.chrom_id] if 0 <= m.chrom_id < len(self.seqs) else None
        if chrom is None:
            return b""
        out = bytearray()
        i = int(np.searchsorted(m.exon_ends, g, side="left"))
        pos = g + 1
        while i < len(m.exon_starts) and len(out) < cap:
            s, e = int(m.exon_starts[i]), int(m.exon_ends[i])
            lo = max(pos, s)
            if lo <= e:
                out.extend(chrom[lo - 1 : e])
            i += 1
            if i < len(m.exon_starts):
                pos = int(m.exon_starts[i])
        return bytes(out[:cap])


def rescue_clips(
    db: RescueDb,
    m: TxModel,
    gstart: int,
    gend: int,
    clip_left: bytes,
    clip_right: bytes,
) -> Tuple[int, int]:
    """Extend the left clip (reversed, leftward from gstart) and right
    clip (forward from gend) against transcript `m`'s exonic context.
    Returns (rescued_left, rescued_right) base counts."""
    rl = rr = 0
    if len(clip_left) >= MIN_CLIP:
        ctx = db.left_context(m, gstart, min(len(clip_left), CLIP_CAP))
        rl = extend_match(clip_left[::-1], ctx)
    if len(clip_right) >= MIN_CLIP:
        ctx = db.right_context(m, gend, min(len(clip_right), CLIP_CAP))
        rr = extend_match(clip_right, ctx)
    return rl, rr


def revcomp(seq: bytes) -> bytes:
    """Reverse complement into genome-forward orientation
    (`projection.rs:295-307`)."""
    return seq.translate(
        bytes.maketrans(b"ACGTUacgtu", b"TGCAAtgcaa")
    )[::-1]
