"""Native projection engine bindings (csrc/project.cpp).

The per-hit Python projection (`project.py::project_blocks` + the
x-drop rescue in `rescue.py`) is ~70% of genome-mode map wall at
GENCODE scale (250k transcripts); this drives the threaded C++ port
over whole mapper batches. The Python implementation remains the
differential oracle (`tests/test_project_native.py` compares them
record-for-record on randomized worlds).

Reference semantics: bramble projection via `bulk.rs:521`,
`projection.rs:238-273`; see project.py's docstrings.

Counterpart of the JAX package's `genome/project_native.py` (host code, kept as a copy so this
package stands alone).
"""

from __future__ import annotations

import ctypes
import logging
from typing import List, Optional, Tuple

import numpy as np

from ..kernels.build import host_library

log = logging.getLogger("oarfish_tpu_torch")

_lib = None
_tried = False

CLIP_CAP = 200


class _ProjResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("hit_off", ctypes.POINTER(ctypes.c_int64)),
        ("tid", ctypes.POINTER(ctypes.c_int32)),
        ("start", ctypes.POINTER(ctypes.c_int64)),
        ("end", ctypes.POINTER(ctypes.c_int64)),
        ("matched", ctypes.POINTER(ctypes.c_int64)),
        ("sim", ctypes.POINTER(ctypes.c_double)),
        ("is_rev", ctypes.POINTER(ctypes.c_uint8)),
    ]


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # built for this machine into the package's build directory
    # (kernels/build.py), never loaded from csrc/; None keeps the Python
    # projection
    lib = host_library("oarfish_project", "project.cpp", native_arch=True)
    if lib is None:
        log.warning("could not build the native projection engine")
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.oarfish_project_batch.restype = ctypes.POINTER(_ProjResult)
    lib.oarfish_project_batch.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i8p, i32p,
        ctypes.c_int64, i64p, i64p, i32p,
        ctypes.c_char_p, i64p,
        ctypes.c_int64, i32p, i64p, i64p, i64p, i64p, i64p, i64p, u8p,
        i64p,
        ctypes.c_char_p, i64p, ctypes.c_char_p, i64p,
        ctypes.c_double, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.oarfish_project_batch_reads.restype = ctypes.POINTER(_ProjResult)
    lib.oarfish_project_batch_reads.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, i64p, i64p, i8p, i32p,
        ctypes.c_int64, i64p, i64p, i32p,
        ctypes.c_char_p, i64p,
        ctypes.c_int64, i32p, i64p, i64p, i64p, i64p, i64p, i64p, u8p,
        i64p,
        ctypes.c_char_p, i64p, i64p, i64p, i64p,
        ctypes.c_double, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.oarfish_project_result_free.argtypes = [
        ctypes.POINTER(_ProjResult)
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


class FlatG2T:
    """Flattened, C-friendly view of a G2TIndex (+ optional genome blob
    for rescue). Built once per run."""

    def __init__(self, g2t, rescue_db=None, genome_blob=None):
        T = g2t.num_transcripts
        n_ex = [len(m.exon_starts) for m in g2t.models]
        self.exon_off = np.zeros(T + 1, np.int64)
        np.cumsum(n_ex, out=self.exon_off[1:])
        self.exon_s = np.concatenate(
            [m.exon_starts for m in g2t.models]
        ) if T else np.empty(0, np.int64)
        self.exon_e = np.concatenate(
            [m.exon_ends for m in g2t.models]
        ) if T else np.empty(0, np.int64)
        self.cum_before = np.concatenate(
            [m.cum_before for m in g2t.models]
        ) if T else np.empty(0, np.int64)
        self.tlen = np.asarray([m.length for m in g2t.models], np.int64)
        self.strand_neg = np.asarray(
            [1 if m.strand == "-" else 0 for m in g2t.models], np.int8
        )
        self.chrom_of = np.asarray(
            [m.chrom_id for m in g2t.models], np.int32
        )
        # bin CSR per chromosome (dense 0..max_bin per chrom)
        n_chroms = len(g2t.refnames)
        self.n_chroms = n_chroms
        nbins = [
            (max(b.keys()) + 1 if b else 0) for b in g2t._bins
        ]
        self.chrom_bin_off = np.zeros(n_chroms + 1, np.int64)
        np.cumsum(nbins, out=self.chrom_bin_off[1:])
        total_bins = int(self.chrom_bin_off[-1])
        counts = np.zeros(total_bins, np.int64)
        for c, bins in enumerate(g2t._bins):
            base = self.chrom_bin_off[c]
            for b, tids in bins.items():
                counts[base + b] = len(tids)
        self.bin_off = np.zeros(total_bins + 1, np.int64)
        np.cumsum(counts, out=self.bin_off[1:])
        self.bin_tids = np.empty(int(self.bin_off[-1]), np.int32)
        for c, bins in enumerate(g2t._bins):
            base = self.chrom_bin_off[c]
            for b, tids in bins.items():
                o = self.bin_off[base + b]
                self.bin_tids[o:o + len(tids)] = tids

        self.gseqs = None
        self.goff = None
        if genome_blob is not None:
            # pre-concatenated uppercase genome (blob, offsets[n_chroms+1]);
            # blob may be bytes or a uint8 array (zero-copy pointer)
            self.gseqs, goff = genome_blob
            self.goff = np.ascontiguousarray(goff, np.int64)
        elif rescue_db is not None:
            seqs = [
                rescue_db.seqs[c] if (
                    c < len(rescue_db.seqs)
                    and rescue_db.seqs[c] is not None
                ) else b""
                for c in range(n_chroms)
            ]
            self.goff = np.zeros(n_chroms + 1, np.int64)
            np.cumsum([len(s) for s in seqs], out=self.goff[1:])
            self.gseqs = b"".join(seqs)


def _p(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def project_batch_native(
    flat: FlatG2T,
    hit_chrom: np.ndarray,
    block_off: np.ndarray,
    block_s: np.ndarray,
    block_e: np.ndarray,
    intron_off: Optional[np.ndarray],
    intron_s: Optional[np.ndarray],
    intron_e: Optional[np.ndarray],
    hit_is_rc: np.ndarray,
    q_aligned: np.ndarray,
    clips: Optional[Tuple[bytes, np.ndarray, bytes, np.ndarray]],
    junc_miss_discount: float,
    tol: int,
    threads: int = 4,
    reads: Optional[Tuple[bytes, np.ndarray, np.ndarray, np.ndarray,
                          np.ndarray]] = None,
):
    """Project a batch of hits. Returns (hit_off, tid, start, end,
    matched, sim, is_rev) numpy arrays (copies; native result freed).

    `reads`, when given, is (seq_blob, read_seq_off, hit_read, qstart,
    qend): soft clips are derived in C++ from each hit's query extent
    (revcomp/uppercase included) instead of `clips` — the raw-read
    mode's per-hit Python clip assembly was ~3s/10k reads."""
    lib = get_lib()
    n_hits = len(hit_chrom)
    i64 = ctypes.c_int64
    null64 = ctypes.POINTER(i64)()

    # materialize every array into a local so the ctypes pointers stay
    # backed for the duration of the call (ascontiguousarray may copy)
    hold = []

    def keep(a, dt):
        a = np.ascontiguousarray(a, dt)
        hold.append(a)
        return a

    def p64o(a):
        return null64 if a is None else _p(keep(a, np.int64), i64)

    if clips is not None:
        cl, cl_off, cr, cr_off = clips
        cl_off = keep(cl_off, np.int64)
        cr_off = keep(cr_off, np.int64)
    else:
        cl = cr = b""
        cl_off = cr_off = None

    gs = flat.gseqs
    if isinstance(gs, np.ndarray):
        gs = gs.ctypes.data_as(ctypes.c_char_p)
    common = (
        len(flat.tlen), _p(flat.exon_off, i64), _p(flat.exon_s, i64),
        _p(flat.exon_e, i64), _p(flat.cum_before, i64),
        _p(flat.tlen, i64), _p(flat.strand_neg, ctypes.c_int8),
        _p(flat.chrom_of, ctypes.c_int32), flat.n_chroms,
        _p(flat.chrom_bin_off, i64), _p(flat.bin_off, i64),
        _p(flat.bin_tids, ctypes.c_int32),
        gs, (null64 if flat.goff is None else _p(flat.goff, i64)),
        n_hits,
        _p(keep(hit_chrom, np.int32), ctypes.c_int32),
        _p(keep(block_off, np.int64), i64),
        _p(keep(block_s, np.int64), i64),
        _p(keep(block_e, np.int64), i64),
        p64o(intron_off), p64o(intron_s), p64o(intron_e),
        _p(keep(hit_is_rc, np.uint8), ctypes.c_uint8),
        _p(keep(q_aligned, np.int64), i64),
    )
    if reads is not None:
        blob, rs_off, hit_read, qstart, qend = reads
        rptr = lib.oarfish_project_batch_reads(
            *common,
            blob, _p(keep(rs_off, np.int64), i64),
            _p(keep(hit_read, np.int64), i64),
            _p(keep(qstart, np.int64), i64),
            _p(keep(qend, np.int64), i64),
            float(junc_miss_discount), int(tol), int(threads),
        )
    else:
        rptr = lib.oarfish_project_batch(
            *common,
            cl, (null64 if cl_off is None else _p(cl_off, i64)),
            cr, (null64 if cr_off is None else _p(cr_off, i64)),
            float(junc_miss_discount), int(tol), int(threads),
        )
    del hold
    r = rptr.contents
    n = int(r.n)

    def arr(p, count, dt):
        if count == 0:
            return np.empty(0, dtype=dt)
        return np.ctypeslib.as_array(p, shape=(count,)).copy()

    out = (
        arr(r.hit_off, n_hits + 1, np.int64),
        arr(r.tid, n, np.int32),
        arr(r.start, n, np.int64),
        arr(r.end, n, np.int64),
        arr(r.matched, n, np.int64),
        arr(r.sim, n, np.float64),
        arr(r.is_rev, n, np.uint8),
    )
    lib.oarfish_project_result_free(rptr)
    return out


def dedup_best(cand_read: np.ndarray, tid: np.ndarray, sim: np.ndarray,
               n_reads: int, T: int):
    """Per (read, tid) keep the max-similarity candidate (first on
    ties), ordered within each read by tid first-encounter — exactly
    the Python paths' `best` dict semantics (project.py
    project_group / the genome_reads per-hit loop). Returns (sel,
    roff): `sel` indexes the candidate arrays; `roff[r]:roff[r+1]`
    spans read r's deduped records."""
    if len(tid) == 0:
        return (np.empty(0, np.int64), np.zeros(n_reads + 1, np.int64))
    key = cand_read.astype(np.int64) * T + tid
    order = np.lexsort((-sim, key))
    ks = key[order]
    keep = np.ones(len(ks), bool)
    keep[1:] = ks[1:] != ks[:-1]
    best_idx = order[keep]
    ukeys, first_pos = np.unique(key, return_index=True)
    final = np.lexsort((first_pos, ukeys // T))
    sel = best_idx[final]
    sel_read = (ukeys // T)[final]
    roff = np.searchsorted(sel_read, np.arange(n_reads + 1))
    return sel, roff
