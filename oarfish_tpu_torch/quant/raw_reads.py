"""Raw-read mode: in-process mapping of FASTA/FASTQ/uBAM reads against a
transcriptome index, then the standard quantification tail.

Host-side equivalent of `quantify_bulk_alignments_raw_reads`
(`bulk.rs:734-1048`) + the aligner plumbing of `util/aligner.rs`: the
reference's producer/mapper/consumer thread pipeline becomes chunked
batch mapping through the C++ mapper (which threads internally), with the
vectorized filter packing each chunk straight into CSR columns.
Index persistence (`--index-out`, `--only-index`, `--index`) carries the
OARFISHSIG digest footer (`digest_utils.rs:34-62`).

Counterpart of the JAX package's `quant/raw_reads.py` (host code, kept as a copy so this
package stands alone).
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np

from ..config import Args, FilterOpts
from ..constants import EMPTY_READ_NAME
from ..host.filters import DiscardTable
from ..host.mapper import Mapper, index_digest_footer
from ..host.store import AlignmentStore, NameBlob, TranscriptCoverage
from ..host.vector_filter import RecordColumns, filter_records
from ..io.fasta import iter_fastx, read_fasta_concat
from ..utils.digest import (
    LazyDigest,
    digest_result_json,
    resolve_lazy_digests,
)
from ..device import resolve_device
from .bulk import perform_inference_and_write_output

log = logging.getLogger("oarfish_tpu_torch")

CHUNK_READS = 50_000


def build_or_load_mapper(args: Args):
    """Aligner/index resolution (`get_aligner_from_args`,
    `aligner.rs:133-216`): load `--index`, or build from
    `--annotated`/`--novel` FASTAs; persist with `--index-out`."""
    from ..host.mapper import set_dp_cache_cap_mb

    set_dp_cache_cap_mb(args.dp_cache_cap_mb)
    if args.index is not None:
        log.info("loading prebuilt index from %s", args.index)
        m = Mapper.load(args.index, threads=max(args.threads, 1))
        try:
            digest = index_digest_footer(args.index)
        except ValueError:
            if m.migrated_seqs is not None:
                # the reference recomputes the full signature from
                # index-embedded sequences when the footer is absent
                # (`aligner.rs:106-117`)
                log.warning(
                    "index has no oarfish digest footer; recomputing "
                    "the reference signature from the index sequences"
                )
                digest = {
                    "index_digest": LazyDigest(
                        digest_result_json, m.names, m.lengths,
                        [s.decode() for s in m.migrated_seqs],
                    )
                }
            else:
                log.warning(
                    "index has no oarfish digest footer; falling back "
                    "to a header-only digest"
                )
                digest = {
                    "index_digest": LazyDigest(
                        digest_result_json, m.names, m.lengths
                    )
                }
        if m.migrated_from is not None and args.index_out is not None:
            m.save(args.index_out,
                   digest_map=resolve_lazy_digests(digest))
            log.info("wrote converted OTMI index to %s", args.index_out)
        m.migrated_seqs = None  # free after digest capture
        return m, digest

    paths = [p for p in (args.annotated, args.novel) if p is not None]
    log.info("building index over %s", ", ".join(str(p) for p in paths))
    names, seqs = read_fasta_concat(paths)
    if not names:
        raise ValueError("no reference sequences found to index")

    # Sequence digests re-read each FASTA and hash its full content;
    # start them on background threads so they overlap the index build
    # (the reference spawns digest threads too, `digest_utils.rs:11-25`,
    # joined before the `--index-out` persist, `aligner.rs:196-204`).
    def _fasta_digest(path):
        f_names, f_seqs = read_fasta_concat([path])
        return digest_result_json(
            f_names, [len(s) for s in f_seqs], [s.decode() for s in f_seqs]
        )

    digest = {}
    if args.annotated is not None:
        digest["annotated_digest"] = LazyDigest(_fasta_digest, args.annotated)
    if args.novel is not None:
        digest["novel_digest"] = LazyDigest(_fasta_digest, args.novel)

    m = Mapper.from_sequences(
        names, seqs, tech=args.seq_tech, threads=max(args.threads, 1)
    )
    if args.index_out is not None:
        m.save(args.index_out, digest_map=resolve_lazy_digests(digest))
        log.info("wrote index to %s", args.index_out)
    return m, digest


def only_index(args: Args) -> int:
    m, _digest = build_or_load_mapper(args)
    log.info(
        "indexing completed; index over %d references written to %s",
        len(m.names),
        args.index_out,
    )
    return 0


def _chunk_columns(hits, read_lens: np.ndarray, discard: DiscardTable):
    """Build RecordColumns for one mapped chunk; reads with zero hits are
    charged to `no_mapping` (the mapper produced nothing for them,
    `oarfish_types.rs:1076-1079`)."""
    n_reads = len(read_lens)
    counts = np.diff(hits.read_off)
    has_hits = counts > 0
    discard.no_mapping += int((~has_hits).sum())
    # dense group ids over reads that have hits (file order)
    gid_of_read = np.cumsum(has_hits) - 1
    rep = np.repeat(np.arange(n_reads), counts)
    cols = RecordColumns(
        group_id=gid_of_read[rep].astype(np.int64),
        flag=np.where(hits.is_rc, 0x10, 0).astype(np.uint16),
        ref_id=hits.target.astype(np.int32),
        pos=hits.tstart.astype(np.int64),
        ref_span=(hits.tend - hits.tstart).astype(np.int64),
        seq_len=read_lens[rep].astype(np.int64),
        score=hits.score.astype(np.int64),
        has_score=np.ones(len(hits.target), dtype=bool),
    )
    return cols, has_hits


def quantify_bulk_alignments_raw_reads(args: Args, opts: FilterOpts):
    # fail before the index build and the mapping, not after them
    resolve_device(args.device)
    t_phase = time.time()
    m, digest = build_or_load_mapper(args)
    log.info("phase rawreads.index %.3f", time.time() - t_phase)
    txps_name = m.names
    txps_len = np.asarray(m.lengths, dtype=np.int64)
    log.info("parsed reference information for %d transcripts.", len(txps_name))

    keep_names = opts.write_assignment_probs
    discard = DiscardTable()
    csr_txp: List[np.ndarray] = []
    csr_start: List[np.ndarray] = []
    csr_end: List[np.ndarray] = []
    csr_prob: List[np.ndarray] = []
    csr_sizes: List[np.ndarray] = []
    names_out = NameBlob() if keep_names else None
    num_unique = 0
    n_reads_total = 0

    t0 = time.time()

    def process_chunk(names, seqs):
        nonlocal num_unique, n_reads_total
        n_reads_total += len(seqs)
        hits = m.map_batch(
            seqs, best_n=args.best_n, threads=max(args.threads, 1)
        )
        read_lens = np.asarray([len(s) for s in seqs], dtype=np.int64)
        cols, has_hits = _chunk_columns(hits, read_lens, discard)
        packed = filter_records(opts, txps_len, cols)
        csr_txp.append(packed.txp_id)
        csr_start.append(packed.start)
        csr_end.append(packed.end)
        csr_prob.append(packed.prob)
        csr_sizes.append(np.diff(packed.boundaries))
        num_unique += packed.num_unique_alignments
        discard.aggregate(packed.discard)
        if names_out is not None:
            hit_names = [n for n, h in zip(names, has_hits) if h]
            for g in packed.group_of_read:
                names_out.append(hit_names[g] or EMPTY_READ_NAME)

    from ..utils.progress import Progress

    names_buf: List[str] = []
    seqs_buf: List[bytes] = []
    with Progress("mapping reads", unit="reads") as prog:
        for path in args.reads:
            for name, seq in iter_fastx(path):
                names_buf.append(name)
                seqs_buf.append(seq)
                if len(seqs_buf) >= CHUNK_READS:
                    process_chunk(names_buf, seqs_buf)
                    prog.update(CHUNK_READS)
                    names_buf, seqs_buf = [], []
        if seqs_buf:
            process_chunk(names_buf, seqs_buf)
            prog.update(len(seqs_buf))

    sizes = (
        np.concatenate(csr_sizes) if csr_sizes else np.empty(0, np.int64)
    )
    boundaries = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=boundaries[1:])
    store = AlignmentStore(
        txp_id=(
            np.concatenate(csr_txp) if csr_txp else np.empty(0, np.int32)
        ),
        start=(
            np.concatenate(csr_start) if csr_start else np.empty(0, np.int64)
        ),
        end=np.concatenate(csr_end) if csr_end else np.empty(0, np.int64),
        as_prob=(
            np.concatenate(csr_prob) if csr_prob else np.empty(0, np.float32)
        ),
        cov_prob=None,
        boundaries=boundaries,
        discard=discard,
        num_unique_alignments=num_unique,
        read_names=names_out,
    )
    store.cov_prob = np.zeros(store.num_alignments, dtype=np.float64)

    coverage = TranscriptCoverage(
        txps_len, args.bin_width if opts.model_coverage else 0
    )
    coverage.add_intervals(store.txp_id, store.start, store.end)

    aln_time_s = time.time() - t0
    log.info(
        "mapped %d reads (%d aligned) in %.3fs",
        n_reads_total,
        store.num_reads,
        aln_time_s,
    )
    log.info("phase rawreads.map %.3f", aln_time_s)

    return perform_inference_and_write_output(
        store,
        coverage,
        txps_name,
        txps_len,
        opts,
        args,
        digest,
        aln_time_s,
    )
