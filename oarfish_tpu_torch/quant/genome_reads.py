"""Genome read-projection mode (`--reads --genome --annotation`).

Host-side equivalent of `run_genome_reads` (`main.rs:239-317`) +
`quantify_genome_raw_reads` (`bulk.rs:337-694`): raw reads are
spliced-aligned to the genome with the native mapper, the chained anchor
blocks are projected onto the annotation's transcripts, filtered
(`filter_projected`), and quantified on device.

Soft-clip rescue against neighboring exon sequence (bramble's
default-on feature, disabled by `--no-rescue`) IS implemented: the
genome sequences are in hand from the FASTA being indexed, a `RescueDb`
is built over them, and each mapped read's soft-clipped tails are
re-aligned against flanking exon sequence during projection
(`genome/rescue.py`; measured in `scripts/rescue_eval.py` — rescue
roughly halves MARD on a simulated skipped-exon world).

Remaining difference from the reference's pipeline (documented
descoping, PARITY.md): the spliced mapper reports chained anchor blocks
rather than base-level CIGARs, so block edges are anchor-resolution and
junction matching uses a tolerance.

Counterpart of the JAX package's `quant/genome_reads.py` (host code, kept as a copy so this
package stands alone).
"""

from __future__ import annotations

import logging
import os
import time
from typing import List

import numpy as np

from ..config import Args, FilterOpts
from ..constants import EMPTY_READ_NAME
from ..genome.annotation import (
    junctions_from_transcripts,
    load_transcripts,
    read_junction_bed,
    write_annotation_junction_bed,
)
from ..genome.g2t import G2TIndex
from ..genome.project import ProjectedAlnRecord, filter_projected, project_blocks
from ..host.mapper import Mapper
from ..host.store import StoreBuilder, TranscriptCoverage
from ..io.fasta import iter_fastx, read_fasta_concat
from ..utils.digest import LazyDigest, digest_result_json
from ..device import resolve_device
from .bulk import perform_inference_and_write_output

log = logging.getLogger("oarfish_tpu_torch")

CHUNK_READS = 20_000


def _is_prebuilt_index(path) -> bool:
    """True when --genome points at an index container rather than a
    FASTA: our OTMI, or a foreign index Mapper.load knows how to
    migrate/reject with a precise message (legacy .mmi / RMMI)."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(8)
    except OSError:
        return False
    # OTMI, legacy minimap2 .mmi (migrated), rammap RMMI (precisely
    # rejected by Mapper.load) — anything else is treated as FASTA
    return head[:5] == b"OTMI\x01" or head[:4] in (
        b"MMI\x02", b"RMI\x01", b"RMMI"
    )


def quantify_genome_raw_reads(args: Args, opts: FilterOpts):
    annotation = args.annotation
    log.info("operating in genome read-projection mode")
    # fail before the annotation, the index and the mapping
    resolve_device(args.device)

    # The annotation work (GTF load, junction derivation, BED write) is
    # pure Python and fully independent of the index build, whose
    # native call releases the GIL — run it on a worker thread UNDER
    # the build (saves the whole annot phase, ~3-5s at GENCODE scale;
    # round 5). The g2t build still needs refnames, so it stays on the
    # main thread after the join.
    from concurrent.futures import ThreadPoolExecutor

    def _load_annotation():
        t0 = time.time()
        log.info("loading annotation from %s", annotation)
        transcripts = load_transcripts(annotation)
        log.info("loaded %d transcripts from annotation", len(transcripts))

        # splice-junction hints for the spliced chainer
        # (`main.rs:255-281`): --junctions BED12 wins; otherwise
        # junctions are derived from the annotation (and the derived
        # BED is also written for parity)
        juncs = None
        if args.junctions is not None:
            juncs = read_junction_bed(args.junctions)
            log.info(
                "loaded splice junctions for %d sequences from %s",
                len(juncs), args.junctions,
            )
        elif not args.ignore_annotation_junctions:
            juncs = junctions_from_transcripts(transcripts)
            bed = (args.output.parent
                   / f"{args.output.name}.annot_junctions.bed")
            try:
                bed.parent.mkdir(parents=True, exist_ok=True)
                n = write_annotation_junction_bed(transcripts, bed)
                log.info(
                    "derived %d spliced transcript models from the "
                    "annotation for the splice-junction BED", n,
                )
            except OSError:
                pass
        log.info("phase genome.annot %.3f (overlapped)", time.time() - t0)
        return transcripts, juncs

    annot_pool = ThreadPoolExecutor(max_workers=1)
    annot_fut = annot_pool.submit(_load_annotation)

    # genome aligner: --genome takes a FASTA or a prebuilt OTMI index
    # (the reference's --genome likewise accepts "a genome FASTA or
    # prebuilt genome index", prog_opts.rs:335-341 — the 2min+ index
    # build over a ~1 Gbp genome amortizes across runs)
    t_phase = time.time()
    from ..host.mapper import set_dp_cache_cap_mb

    set_dp_cache_cap_mb(args.dp_cache_cap_mb)
    g_seqs = None
    try:
        if _is_prebuilt_index(args.genome):
            log.info("loading prebuilt genome index from %s", args.genome)
            # peek the name table (ms) so the g2t build rides under the
            # full index load on the worker, as in the FASTA branch
            from ..host.mapper import peek_index_names

            peeked = peek_index_names(args.genome)
            if peeked is not None:
                def _build_g2t_prebuilt():
                    transcripts, _ = annot_fut.result()
                    t0 = time.time()
                    g2t = G2TIndex(transcripts, peeked)
                    log.info("phase genome.g2t %.3f (overlapped)",
                             time.time() - t0)
                    return g2t

                g2t_fut = annot_pool.submit(_build_g2t_prebuilt)
            mapper = Mapper.load(args.genome, threads=max(args.threads, 1))
            g_names = mapper.names
            if peeked is not None and peeked != list(mapper.names):
                # defensive: a foreign-index migration path could in
                # principle rename targets; fall back to a fresh build
                del g2t_fut
        else:
            t_sub = time.time()
            g_names, g_seqs = read_fasta_concat([args.genome])
            if not g_names:
                raise ValueError(
                    f"no sequences found in genome {args.genome}")
            log.info("phase genome.index.fasta %.3f", time.time() - t_sub)

            # chain the g2t build and the rescue blob onto the same
            # worker: they only need the annotation + the FASTA names/
            # sequences, all in hand before the (GIL-free) index build
            # starts, so the whole aux phase rides under it
            def _build_g2t_overlapped():
                transcripts, _ = annot_fut.result()
                t0 = time.time()
                g2t = G2TIndex(transcripts, list(g_names))
                log.info("phase genome.g2t %.3f (overlapped)",
                         time.time() - t0)
                return g2t

            def _build_blob_overlapped():
                t0 = time.time()
                goff = np.zeros(len(g_seqs) + 1, np.int64)
                np.cumsum([len(x) for x in g_seqs], out=goff[1:])
                blob = (b"".join(g_seqs).upper(), goff)
                log.info("phase genome.rescueblob %.3f (overlapped)",
                         time.time() - t0)
                return blob

            g2t_fut = annot_pool.submit(_build_g2t_overlapped)
            blob_fut = (annot_pool.submit(_build_blob_overlapped)
                        if not args.no_rescue else None)
            t_sub = time.time()
            mapper = Mapper.from_sequences(
                g_names, g_seqs, tech=args.seq_tech,
                threads=max(args.threads, 1),
            )
            log.info("phase genome.index.build %.3f", time.time() - t_sub)
            if args.index_out is not None:
                t_sub = time.time()
                mapper.save(args.index_out)
                log.info("wrote genome index to %s (%.3fs)",
                         args.index_out, time.time() - t_sub)
    except BaseException:
        annot_pool.shutdown(wait=False, cancel_futures=True)
        raise
    transcripts, juncs = annot_fut.result()
    refnames = mapper.names
    if juncs:
        n_j = mapper.set_junctions(juncs)
        log.info("loaded %d annotated splice junctions into the chainer", n_j)
    log.info("phase genome.index %.3f", time.time() - t_phase)

    t_phase = time.time()
    try:
        g2t = g2t_fut.result()
    except NameError:
        g2t = G2TIndex(transcripts, refnames)

    # soft-clip rescue: on by default (genome sequences are in hand
    # from the FASTA we just indexed — or copied back out of a
    # prebuilt index, which embeds them for rescoring), disabled by
    # --no-rescue. The native projection engine takes one concatenated
    # uppercase blob; the Python fallback builds a per-chrom RescueDb.
    import os as _os

    from ..genome import project_native as pn

    rescue_on = not args.no_rescue
    use_native = (
        _os.environ.get("OARFISH_PROJECT_NATIVE", "1") != "0"
        and pn.available()
    )
    rescue_db = None
    genome_blob = None
    if rescue_on:
        if use_native:
            if g_seqs is not None:
                try:
                    genome_blob = blob_fut.result()
                except NameError:
                    goff = np.zeros(len(g_seqs) + 1, np.int64)
                    np.cumsum([len(s) for s in g_seqs], out=goff[1:])
                    genome_blob = (b"".join(g_seqs).upper(), goff)
            else:
                # uint8 array, uppercased in place — zero bytes copies
                genome_blob = mapper.sequences_blob()
        else:
            from ..genome.rescue import RescueDb

            if g_seqs is None:
                g_seqs = mapper.sequences()
            rescue_db = RescueDb(
                {n: s.upper() for n, s in zip(g_names, g_seqs)}, refnames
            )

    txps_name = list(g2t.names)
    txps_len = g2t.transcript_lengths()
    log.info("built g2t index over %d transcripts", g2t.num_transcripts)
    digest = {
        "transcriptome_digest": LazyDigest(
            digest_from_names_lengths, txps_name, txps_len
        )
    }

    coverage = TranscriptCoverage(
        txps_len, args.bin_width if opts.model_coverage else 0
    )
    builder = StoreBuilder(coverage, keep_names=opts.write_assignment_probs)

    # native projection engine (csrc/project.cpp): the per-hit Python
    # projection + rescue is ~70% of map wall at GENCODE scale; the
    # Python path below remains the fallback and differential oracle
    flat_g2t = None
    if use_native:
        flat_g2t = pn.FlatG2T(g2t, genome_blob=genome_blob)
    annot_pool.shutdown(wait=False)
    log.info("phase genome.aux %.3f", time.time() - t_phase)
    n_reads_total = 0
    n_mapped = 0

    t0 = time.time()

    def process_chunk_native(names, seqs, hits):
        """Whole-batch projection via csrc/project.cpp. Semantics (and
        record order, hence byte-identical outputs) match the per-hit
        Python path below — `tests/test_project_native.py` and the
        genome-mode CLI tests pin the equivalence."""
        nonlocal n_reads_total, n_mapped
        n_reads = len(seqs)
        n_reads_total += n_reads
        read_off = np.asarray(hits.read_off, np.int64)
        n_hits = int(read_off[-1])
        if n_hits == 0:
            builder.discard.no_mapping += n_reads
            return
        bo = np.asarray(hits.block_off, np.int64)
        bs = np.asarray(hits.block_s, np.int64) + 1  # 1-based inclusive
        be = np.asarray(hits.block_e, np.int64)
        nb = np.diff(bo)
        total_blocks = len(bs)
        # introns: every gap between consecutive blocks within a hit
        # (including degenerate gaps — the Python path keeps them too)
        if total_blocks > 1:
            last_of_hit = np.zeros(total_blocks, bool)
            ends = bo[1:][nb > 0] - 1
            last_of_hit[ends] = True
            gap_sel = ~last_of_hit
            gap_sel[total_blocks - 1] = False
            gj = np.nonzero(gap_sel)[0]
            intron_s = be[gj] + 1
            intron_e = bs[gj + 1] - 1
        else:
            intron_s = intron_e = np.empty(0, np.int64)
        intron_off = np.zeros(n_hits + 1, np.int64)
        np.cumsum(np.maximum(nb - 1, 0), out=intron_off[1:])

        hit_read = np.repeat(np.arange(n_reads), np.diff(read_off))
        reads_arg = None
        if rescue_on:
            # clips derive in C++ from the reads blob + query extents
            rs_off = np.zeros(n_reads + 1, np.int64)
            np.cumsum([len(s) for s in seqs], out=rs_off[1:])
            reads_arg = (
                b"".join(seqs), rs_off, hit_read,
                np.asarray(hits.qstart, np.int64),
                np.asarray(hits.qend, np.int64),
            )

        from ..genome import project_native as pn

        hit_off, tid, pstart, pend, matched, sim, is_rev = (
            pn.project_batch_native(
                flat_g2t,
                hit_chrom=np.asarray(hits.target, np.int32),
                block_off=bo, block_s=bs, block_e=be,
                intron_off=intron_off, intron_s=intron_s,
                intron_e=intron_e,
                hit_is_rc=np.asarray(hits.is_rc, np.uint8),
                q_aligned=(np.asarray(hits.qend, np.int64)
                           - np.asarray(hits.qstart, np.int64)),
                clips=None,
                junc_miss_discount=args.junc_miss_discount,
                tol=mapper.k + mapper.w,
                threads=max(args.threads, 1),
                reads=reads_arg,
            )
        )
        ccount = np.diff(hit_off)
        cand_read = np.repeat(hit_read, ccount)
        cand_score = np.repeat(np.asarray(hits.score, np.int64), ccount)
        sel, roff = pn.dedup_best(
            cand_read, tid, sim, n_reads, g2t.num_transcripts
        )

        if os.environ.get("OARFISH_BATCH_FILTER", "1") != "0":
            # vectorized filter over the whole batch (the per-read
            # ProjectedAlnRecord loop below, kept as the differential
            # oracle, was most of the map-phase wall at GENCODE scale)
            from ..genome.project import filter_projected_batch

            hits_per_read = np.diff(read_off)
            cand_per_read = np.diff(roff)
            builder.discard.no_mapping += int((hits_per_read == 0).sum())
            n_mapped += int((hits_per_read > 0).sum())
            builder.discard.no_valid_aln += int(
                ((hits_per_read > 0) & (cand_per_read == 0)).sum()
            )
            tid_d = tid[sel]
            ps_d = pstart[sel]
            pe_d = pend[sel]
            kept, prob, read_ok = filter_projected_batch(
                opts, builder.discard, txps_len, roff,
                tid_d, ps_d, pe_d, matched[sel], sim[sel],
                cand_score[sel], np.asarray(is_rev[sel], bool),
                np.asarray([len(x) for x in seqs], np.int64),
                args.projected_prob_beta, args.projected_prob_source,
            )
            if read_ok.any():
                rid_d = np.repeat(np.arange(n_reads), cand_per_read)
                tlk = txps_len[tid_d[kept]]
                s_c = np.minimum(np.maximum(ps_d[kept], 1), tlk)
                e_c = np.minimum(np.maximum(pe_d[kept], s_c), tlk)
                sizes = np.bincount(
                    rid_d[kept], minlength=n_reads
                )[read_ok]
                batch_names = None
                if builder.read_names is not None:
                    batch_names = [
                        names[r] or EMPTY_READ_NAME
                        for r in np.nonzero(read_ok)[0]
                    ]
                builder.add_filtered_batch(
                    tid_d[kept], s_c, e_c, prob[kept], sizes,
                    names=batch_names,
                )
                builder.num_unique_alignments += int(
                    ((hits_per_read == 1) & read_ok).sum()
                )
            return

        for r in range(n_reads):
            s, e = int(read_off[r]), int(read_off[r + 1])
            if e == s:
                builder.discard.no_mapping += 1
                continue
            n_mapped += 1
            a, b = int(roff[r]), int(roff[r + 1])
            if a == b:
                builder.discard.no_valid_aln += 1
                continue
            projected = [
                ProjectedAlnRecord(
                    ref_id=int(tid[j]), start=int(pstart[j]),
                    end=int(pend[j]),
                    aligned_len=int(pend[j] - pstart[j] + 1),
                    query_aligned_len=int(matched[j]),
                    is_reverse=bool(is_rev[j]),
                    similarity=float(sim[j]),
                    aln_score=int(cand_score[j]),
                )
                for j in sel[a:b]
            ]
            fg = filter_projected(
                opts, builder.discard, txps_len, projected, len(seqs[r]),
                args.projected_prob_beta, args.projected_prob_source,
            )
            if fg is not None and builder.add_filtered_group(
                fg, names[r] or EMPTY_READ_NAME
            ):
                if e - s == 1:
                    builder.num_unique_alignments += 1

    def process_chunk(names: List[str], seqs: List[bytes]):
        nonlocal n_reads_total, n_mapped
        hits = mapper.map_batch(
            seqs, best_n=args.best_n, threads=max(args.threads, 1),
            spliced=True,
        )
        if flat_g2t is not None:
            return process_chunk_native(names, seqs, hits)
        n_reads_total += len(seqs)
        for i, name in enumerate(names):
            s, e = int(hits.read_off[i]), int(hits.read_off[i + 1])
            if e == s:
                builder.discard.no_mapping += 1
                continue
            n_mapped += 1
            best: dict = {}
            for h in range(s, e):
                bo_s, bo_e = int(hits.block_off[h]), int(hits.block_off[h + 1])
                blocks = [
                    (int(hits.block_s[b]) + 1, int(hits.block_e[b]))
                    for b in range(bo_s, bo_e)
                ]
                introns = [
                    (blocks[j][1] + 1, blocks[j + 1][0] - 1)
                    for j in range(len(blocks) - 1)
                ]
                q_aligned = int(hits.qend[h] - hits.qstart[h])
                rescue = None
                if rescue_db is not None:
                    from ..genome.rescue import revcomp

                    rd = seqs[i]
                    is_rc = bool(hits.is_rc[h])
                    # reference-forward orientation (projection.rs:295-307)
                    fwd = revcomp(rd) if is_rc else rd
                    qs, qe = int(hits.qstart[h]), int(hits.qend[h])
                    c5 = len(rd) - qe if is_rc else qs
                    c3 = qs if is_rc else len(rd) - qe
                    if c5 >= 3 or c3 >= 3:
                        rescue = (
                            rescue_db,
                            fwd[:c5].upper() if c5 else b"",
                            fwd[len(fwd) - c3 :].upper() if c3 else b"",
                        )
                for rec in project_blocks(
                    int(hits.target[h]), blocks, introns, q_aligned,
                    bool(hits.is_rc[h]), int(hits.score[h]), g2t,
                    args.junc_miss_discount,
                    junction_tolerance=mapper.k + mapper.w,
                    rescue=rescue,
                ):
                    prev = best.get(rec.ref_id)
                    if prev is None or rec.similarity > prev.similarity:
                        best[rec.ref_id] = rec
            projected = list(best.values())
            if not projected:
                builder.discard.no_valid_aln += 1
                continue
            fg = filter_projected(
                opts, builder.discard, txps_len, projected, len(seqs[i]),
                args.projected_prob_beta, args.projected_prob_source,
            )
            if fg is not None and builder.add_filtered_group(
                fg, name or EMPTY_READ_NAME
            ):
                if e - s == 1:
                    builder.num_unique_alignments += 1

    from ..utils.progress import Progress

    names_buf: List[str] = []
    seqs_buf: List[bytes] = []
    with Progress("mapping + projecting reads", unit="reads") as prog:
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

    store = builder.finalize()
    aln_time_s = time.time() - t0
    log.info(
        "mapped %d/%d reads; %d quantified groups in %.3fs",
        n_mapped, n_reads_total, store.num_reads, aln_time_s,
    )
    log.info("phase genome.map %.3f", aln_time_s)

    return perform_inference_and_write_output(
        store, coverage, txps_name, txps_len, opts, args, digest, aln_time_s
    )


def digest_from_names_lengths(names, lengths):
    return digest_result_json(names, [int(x) for x in lengths])
