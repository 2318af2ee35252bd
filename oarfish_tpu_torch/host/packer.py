"""Streaming BAM → CSR packing: group records by read name, filter, pack.

Host-side equivalent of `parse_alignments` (`alignment_parser.rs:301-437`):
records are streamed from the (parallel-inflated) BAM, grouped by contiguous
read name, run through the alignment filters, and appended to the CSR store.
The first `sort_check_num` read names are hashed to verify the input is
name-collated (`alignment_parser.rs:396-409`).

Counterpart of the JAX package's `host/packer.py` (host code, kept as a copy so this
package stands alone).
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Optional, Tuple

import numpy as np

from ..config import FilterOpts
from ..constants import EMPTY_READ_NAME
from ..io.bam import BamReader, BamRecord
from ..utils import trace
from .filters import filter_group
from .store import AlignmentStore, StoreBuilder, TranscriptCoverage

log = logging.getLogger("oarfish_tpu_torch")


class CollationError(ValueError):
    pass


def iter_name_groups(records: Iterable[BamRecord], sort_check_num: int = 100_000):
    """Yield (name, [mapped records]) groups of contiguous read names,
    counting unmapped records; raises CollationError if a name recurs in a
    non-contiguous block within the first `sort_check_num` groups."""
    seen = set()
    rg_num = 0
    prev_name: Optional[str] = None
    group = []
    num_unmapped = 0
    for rec in records:
        if rec.is_unmapped:
            num_unmapped += 1
            continue
        if rec.name == prev_name:
            if rec.ref_id >= 0:
                group.append(rec)
        else:
            if prev_name is not None and group:
                yield prev_name, group
            group = []
            prev_name = rec.name
            if rg_num < sort_check_num:
                if rec.name in seen:
                    raise CollationError(
                        "the input BAM appears not to be name-collated: "
                        f"alignment records for read {rec.name!r} were "
                        "observed twice in a non-contiguous block. Provide a "
                        "BAM collated by record name."
                    )
                seen.add(rec.name)
                rg_num += 1
            if rec.ref_id >= 0:
                group.append(rec)
    if group:
        yield prev_name, group
    iter_name_groups.num_unmapped = num_unmapped  # exposed for the caller


def pack_bam(
    reader: BamReader,
    txp_len: np.ndarray,
    opts: FilterOpts,
    bin_width: int,
    sort_check_num: int = 100_000,
    keep_names: bool = False,
) -> Tuple[AlignmentStore, TranscriptCoverage, int]:
    """Stream the open BAM into an `AlignmentStore` + coverage bins.

    Returns (store, coverage, num_unmapped). This is the host half of the
    pipeline — everything downstream runs on device.
    """
    coverage = TranscriptCoverage(
        txp_len, bin_width if opts.model_coverage else 0
    )
    builder = StoreBuilder(coverage, keep_names=keep_names)

    from ..utils.progress import Progress

    gen = iter_name_groups(reader.records(), sort_check_num)
    n_groups = 0
    with Progress("parsing alignments", unit="read groups") as prog:
        for name, group in gen:
            fg = filter_group(opts, builder.discard, txp_len, group)
            if fg is not None and builder.add_filtered_group(
                fg, name if name else EMPTY_READ_NAME
            ):
                # the reference filters the group in place, so uniqueness is
                # judged on the POST-filter size (`alignment_parser.rs:384-388`)
                if len(fg.txp_id) == 1:
                    builder.num_unique_alignments += 1
            n_groups += 1
            prog.update()
            if n_groups % 500_000 == 0:
                log.info("processed %d read groups", n_groups)

    num_unmapped = getattr(iter_name_groups, "num_unmapped", 0)
    store = builder.finalize()
    log.info(
        "the alignment file contained %d unmapped read records.", num_unmapped
    )
    return store, coverage, num_unmapped


def _collation_error(dup_name: str) -> CollationError:
    return CollationError(
        "the input BAM appears not to be name-collated: alignment "
        f"records for read {dup_name!r} were observed twice in a "
        "non-contiguous block. Provide a BAM collated by record name."
    )


def pack_bam_stream(
    path,
    opts: FilterOpts,
    bin_width: int,
    threads: int = 4,
    sort_check_num: int = 100_000,
    keep_names: bool = False,
    chunk_observer=None,
):
    """Overlapped streaming pack: the C++ decoder produces group-aligned
    columnar chunks on a producer thread (the ctypes call releases the
    GIL, so BGZF inflate + record scan of chunk k+1 run concurrently
    with the vectorized filter/coverage/pack of chunk k on the main
    thread) — the pipeline shape of the reference's producer→consumer
    ingest (`bulk.rs:364-682`). Returns (header, store, coverage,
    num_unmapped), or None when the native library is unavailable.

    The innermost open span (`utils/trace.py`) gets the attributes
    `decode_wait_s`, `filter_s`, `tail_s`, `wall_s` and `chunks`:
    decode_wait_s is the time the consumer would have spent blocked on
    decode had there been no overlap.

    The filter itself runs on a small pool when cores are plentiful
    (threads >= 6, like the decoder's inflate pipeline;
    OARFISH_FILTER_THREADS overrides): chunks are filtered out of order
    but ACCUMULATED strictly in order, so the CSR, the prebuild
    observer stream, and the name blobs are byte-identical to the
    serial path (coverage bins are FP-accumulation-order tolerant, as
    with any chunking change). Below the threshold the pool has one
    worker: outputs are identical to the old inline filter, but
    collection is deferred (pending depth up to 2), so filtering of
    chunk k still overlaps chunk k+1's decode and `filter_s` includes
    block-on-result wait — timing/RSS semantics differ from a truly
    inline pass."""
    import queue
    import threading
    import time as _time
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from . import native
    from .filters import DiscardTable
    from .store import NameBlob
    from .vector_filter import filter_records

    gen = native.stream_bam(
        path,
        threads=threads,
        keep_names=keep_names,
        sort_check_num=sort_check_num,
    )
    if gen is None:
        return None

    t_wall0 = _time.perf_counter()
    q: "queue.Queue" = queue.Queue(maxsize=2)
    t_decode = [0.0]
    # set on a consumer-side error so the producer stops decoding
    # immediately instead of inflating the rest of the file (a
    # collation failure surfaces within the first chunks; without this
    # a 50 GB BAM would decode to completion before the error shows)
    stop = threading.Event()

    def produce():
        try:
            t0 = _time.perf_counter()
            for chunk in gen:
                t_decode[0] += _time.perf_counter() - t0
                while not stop.is_set():
                    try:
                        q.put(chunk, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    gen.close()
                    return
                t0 = _time.perf_counter()
            q.put(None)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            q.put(e)

    th = threading.Thread(target=produce, daemon=True)
    th.start()

    header = None
    txp_len = None
    coverage = None

    class _Grow:
        """Amortized-growth flat array: chunk CSRs are copied in as they
        are collected (riding under the decode overlap) instead of a
        one-shot np.concatenate tail after the stream ends (~1.3s at
        A=15M, PERF_NOTES round 5 pack-wall)."""

        __slots__ = ("buf", "n")

        def __init__(self, dtype):
            self.buf = np.empty(1 << 20, dtype=dtype)
            self.n = 0

        def add(self, arr):
            need = self.n + len(arr)
            if need > len(self.buf):
                cap = max(need, int(len(self.buf) * 1.7))
                nb = np.empty(cap, dtype=self.buf.dtype)
                nb[: self.n] = self.buf[: self.n]
                self.buf = nb
            self.buf[self.n : need] = arr
            self.n = need

        def finish(self):
            out = self.buf[: self.n]
            self.buf = None
            return out

    g_txp = _Grow(np.int32)
    g_start = _Grow(np.int64)
    g_end = _Grow(np.int64)
    g_prob = _Grow(np.float32)
    g_bnd = _Grow(np.int64)
    g_bnd.add(np.zeros(1, dtype=np.int64))
    aln_base = [0]
    name_chunks = []
    # spill kept names to disk as chunks arrive (bounded RSS at 1e8
    # reads, like the reference's swapvec — see NameSpill docstring);
    # OARFISH_NAME_SPILL=0 keeps them resident
    spill = None
    if keep_names and os.environ.get("OARFISH_NAME_SPILL") != "0":
        from .store import NameSpill

        spill = NameSpill()
    from ..utils.progress import Progress

    discard = DiscardTable()
    num_unique = 0
    num_unmapped = 0
    t_filter = 0.0
    n_chunks = 0
    prog = Progress("parsing alignments", unit="records")

    fworkers = 1 if threads < 6 else max(1, threads // 3)
    if os.environ.get("OARFISH_FILTER_THREADS"):
        fworkers = max(1, int(os.environ["OARFISH_FILTER_THREADS"]))
    pool = ThreadPoolExecutor(max_workers=fworkers)
    pending: deque = deque()  # (future, chunk) in arrival order

    def collect_one():
        """Accumulate the oldest filtered chunk (strictly in order)."""
        nonlocal num_unique, num_unmapped, t_filter
        fut, chunk = pending.popleft()
        t0 = _time.perf_counter()  # includes the block-on-filter wait
        packed = fut.result()
        coverage.add_intervals(packed.txp_id, packed.start, packed.end)
        if keep_names:
            if chunk.group_names is not None:
                blob = NameBlob.from_indexed(
                    chunk.group_names, packed.group_of_read
                )
                if spill is not None:
                    spill.add(blob)
                else:
                    name_chunks.append(blob)
            elif len(packed.group_of_read):
                raise ValueError(f"{path}: stream chunk missing group names")
        g_txp.add(packed.txp_id)
        g_start.add(packed.start)
        g_end.add(packed.end)
        g_prob.add(packed.prob)
        if len(packed.boundaries) > 1:
            g_bnd.add(packed.boundaries[1:] + aln_base[0])
            aln_base[0] += int(packed.boundaries[-1])
        if chunk_observer is not None:
            # feed the routed-EM prebuilder (ops/em_v4.V4Prebuild):
            # layout pre-work runs on its thread while later chunks
            # decode — the pack→build overlap (VERDICT r2 next-1)
            chunk_observer(packed)
        discard.aggregate(packed.discard)
        num_unique += packed.num_unique_alignments
        num_unmapped += chunk.num_unmapped
        prog.update(len(chunk.columns.flag) + chunk.num_unmapped)
        t_filter += _time.perf_counter() - t0

    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            chunk = item
            n_chunks += 1
            if chunk.dup_name is not None:
                raise _collation_error(chunk.dup_name)
            if header is None:
                if chunk.header is None:
                    raise ValueError(f"{path}: stream chunk missing header")
                header = chunk.header
                txp_len = np.asarray(header.ref_lengths, dtype=np.int64)
                coverage = TranscriptCoverage(
                    txp_len, bin_width if opts.model_coverage else 0
                )
                # persistent native accumulator: alloc/zero the
                # per-thread partial bins once for the whole stream
                # instead of per chunk (~5s saved at 14M bins)
                coverage.begin_accumulation(threads=threads)
            t0 = _time.perf_counter()
            pending.append(
                (pool.submit(filter_records, opts, txp_len, chunk.columns),
                 chunk)
            )
            t_filter += _time.perf_counter() - t0
            # bound in-flight chunks (each holds its columnar arrays)
            while len(pending) > fworkers + 1 or (
                pending and pending[0][0].done()
            ):
                collect_one()
        while pending:
            collect_one()
        if coverage is not None:
            t0 = _time.perf_counter()
            coverage.finish_accumulation()
            t_filter += _time.perf_counter() - t0
    except BaseException:
        if coverage is not None:
            coverage.abort_accumulation()
        raise
    finally:
        prog.close()
        stop.set()  # cancel the producer's decode-in-progress
        pool.shutdown(wait=True, cancel_futures=True)
        # drain one slot in case the producer is mid-put
        while th.is_alive():
            try:
                q.get(timeout=0.2)
            except queue.Empty:
                pass
            th.join(timeout=0.2)
        th.join(timeout=60.0)

    # --- finalize the incrementally-assembled CSR
    t_tail0 = _time.perf_counter()
    txp_id = g_txp.finish()
    start = g_start.finish()
    end = g_end.finish()
    prob = g_prob.finish()
    boundaries = g_bnd.finish()
    if spill is not None:
        read_names = spill.finish()
    elif keep_names:
        read_names = NameBlob.concat(name_chunks)
    else:
        read_names = None

    store = AlignmentStore(
        txp_id=txp_id,
        start=start,
        end=end,
        as_prob=prob,
        cov_prob=np.zeros(len(txp_id), dtype=np.float64),
        boundaries=boundaries,
        discard=discard,
        num_unique_alignments=num_unique,
        read_names=read_names,
    )
    trace.annotate(decode_wait_s=t_decode[0], filter_s=t_filter,
                   tail_s=_time.perf_counter() - t_tail0,
                   wall_s=_time.perf_counter() - t_wall0, chunks=n_chunks)
    log.info(
        "the alignment file contained %d unmapped read records.", num_unmapped
    )
    log.info(
        "streamed pack: %d chunks, decode %.2fs || filter+pack %.2fs, "
        "wall %.2fs",
        n_chunks, t_decode[0], t_filter, _time.perf_counter() - t_wall0,
    )
    return header, store, coverage, num_unmapped


def pack_bam_fast(
    path,
    opts: FilterOpts,
    bin_width: int,
    threads: int = 4,
    sort_check_num: int = 100_000,
    keep_names: bool = False,
    chunk_observer=None,
):
    """Fast pack: overlapped streaming decode + vectorized filtering +
    CSR assembly (C++ decoder), falling back to the Python reader when
    the native library is unavailable. Returns (header, store, coverage,
    num_unmapped).

    `pack_bam` (streaming per-group) remains as the differential oracle;
    OARFISH_STREAM_PACK=0 pins the old whole-file-decode-then-filter
    path for A/B."""
    from ..io.bam import BamReader
    from . import native
    from .filters import DiscardTable
    from .vector_filter import columns_from_records, filter_records

    if os.environ.get("OARFISH_STREAM_PACK") != "0":
        res = pack_bam_stream(
            path,
            opts,
            bin_width,
            threads=threads,
            sort_check_num=sort_check_num,
            keep_names=keep_names,
            chunk_observer=chunk_observer,
        )
        if res is not None:
            return res

    dec = native.decode_bam(
        path,
        threads=threads,
        keep_names=keep_names,
        sort_check_num=sort_check_num,
    )
    if dec is not None:
        header = dec.header
        cols = dec.columns
        num_unmapped = dec.num_unmapped
        group_names = dec.group_names
        if dec.dup_name is not None:
            raise _collation_error(dec.dup_name)
    else:
        reader = BamReader(path, threads=threads)
        header = reader.header
        # reuse the collation check from the streaming path
        seen = set()
        names_acc = []

        def checked(records):
            prev = None
            rg = 0
            for rec in records:
                if not rec.is_unmapped and rec.name != prev:
                    if rg < sort_check_num:
                        if rec.name in seen:
                            raise CollationError(
                                "the input BAM appears not to be "
                                f"name-collated: read {rec.name!r} observed "
                                "twice in a non-contiguous block."
                            )
                        seen.add(rec.name)
                        rg += 1
                    prev = rec.name
                yield rec

        cols, names_acc, num_unmapped = columns_from_records(
            checked(reader.records())
        )
        group_names = names_acc if keep_names else None

    txp_len = np.asarray(header.ref_lengths, dtype=np.int64)
    packed = filter_records(opts, txp_len, cols)

    coverage = TranscriptCoverage(
        txp_len, bin_width if opts.model_coverage else 0
    )
    coverage.add_intervals(packed.txp_id, packed.start, packed.end)

    read_names = None
    if keep_names and group_names is not None:
        from .store import NameBlob

        read_names = NameBlob.from_indexed(
            group_names, packed.group_of_read
        )

    store = AlignmentStore(
        txp_id=packed.txp_id,
        start=packed.start,
        end=packed.end,
        as_prob=packed.prob,
        cov_prob=np.zeros(len(packed.txp_id), dtype=np.float64),
        boundaries=packed.boundaries,
        discard=packed.discard,
        num_unique_alignments=packed.num_unique_alignments,
        read_names=read_names,
    )
    log.info(
        "the alignment file contained %d unmapped read records.", num_unmapped
    )
    return header, store, coverage, num_unmapped
