"""Single-cell quantification: per-barcode EM over a CB-collated BAM.

Counterpart of the JAX package's `quant/single_cell.py` (reference
behavior: `single_cell.rs:54-267` and the per-barcode helpers of
`alignment_parser.rs:170-299`). Records are peeled per contiguous CB tag,
name-sorted (primary before secondary), filtered, given a per-cell
binomial coverage model, and quantified with an independent EM per cell;
the output is a cells x transcripts MatrixMarket matrix with the barcode
and feature lists.

As in the JAX package, cells are packed into size buckets (alignments,
reads and transcripts padded to powers of two, at most 12 shapes after
`coarsen_buckets`), each cell's transcripts relabeled to a dense local
space, and each bucket runs as one batched EM with per-cell freezing, on
the torch device the caller names (`args.device`, default `cuda`):

* `dense` (`auto` on the card): the incidence structure as one-hot
  matrices and the E/M step as batched products (`ops/em_dense.py`), in
  sub-batches under a device-memory budget;
* `segsum` (`auto` on the CPU): the bucket's cells as one flattened CSR
  (cell i's transcripts offset by `i * (t_pad + 1)`, its reads by
  `i * (r_pad + 1)`, with a dummy read and a dummy transcript per cell)
  through the segment-sum m-step of `ops/em.py`, the abundances viewed as
  `[cells, t_pad + 1]` around each step so that the convergence test and
  the freezing stay per cell.

`OARFISH_SC_IMPL`, `OARFISH_SC_MAX_BUCKETS` and `OARFISH_SC_DENSE_BUDGET_MB`
are honoured as in the JAX package. The buckets run one after another in
sorted-key order, each bucket's counts come back to the host once, when it
is done, and no more than one bucket's device tensors exist at a time.
With `--num-shards D > 1` and several cards (`cell_devices`, the
counterpart of `_cell_mesh`: min(D, cards) devices, one on the CPU) each
bucket's cells are cut into one contiguous part per device and the parts'
counts gathered back in cell order; cells are independent, so the output
is the single-device run's. Under several processes each process runs the
whole single-cell quantification and writes its own `--output`, as the JAX
CLI does (the mode takes no collective). Not ported: the padding of batch
sizes to a ladder of shapes, which serves XLA's compilation cache only.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Args, FilterOpts
from ..device import resolve_device, resolve_em_dtype
from ..host.filters import DiscardTable, filter_group
from ..host.store import AlignmentStore, StoreBuilder, TranscriptCoverage
from ..io.bam import BamReader, BamRecord, verify_header
from ..models.coverage import binomial_continuous_prob, normalize_read_probs
from ..ops.em import EmData, _m_step, em_loop, finish_em, squarem_em
from ..ops.em_dense import DenseCellEm, run_em_dense_scan
from ..utils import trace
from ..utils.digest import (
    LazyDigest,
    digest_from_header,
    resolve_lazy_digests,
)
from .meta import humantime
from .writers import write_single_cell_output

log = logging.getLogger("oarfish_tpu_torch")

SC_IMPLS = ("auto", "dense", "segsum")


def iter_barcode_groups(records) -> Iterator[Tuple[bytes, List[BamRecord]]]:
    """Yield (barcode, mapped records) for contiguous CB blocks
    (`parse_alignments_for_barcode`, `alignment_parser.rs:244-299`).
    Barcodes are uppercased for comparison (`single_cell.rs:202-210`)."""
    current: Optional[bytes] = None
    group: List[BamRecord] = []
    for rec in records:
        if rec.is_unmapped:
            continue
        if rec.barcode is None:
            raise ValueError("could not get CB tag value")
        bc = rec.barcode.upper()
        if bc != current:
            if current is not None and group:
                yield current, group
            current = bc
            group = []
        group.append(rec)
    if current is not None and group:
        yield current, group


def build_cell_store(
    records: List[BamRecord],
    txp_len: np.ndarray,
    opts: FilterOpts,
    bin_width: int,
) -> Tuple[AlignmentStore, TranscriptCoverage]:
    """Per-cell store: name-sort with primary-first
    (`sort_and_parse_barcode_records`, `alignment_parser.rs:170-241`),
    group by name, filter, pack."""
    records = sorted(records, key=lambda r: (r.name, r.is_secondary))
    coverage = TranscriptCoverage(
        txp_len, bin_width if opts.model_coverage else 0
    )
    builder = StoreBuilder(coverage)
    group: List[BamRecord] = []
    prev = None
    for rec in records:
        if rec.name != prev:
            if group:
                fg = filter_group(opts, builder.discard, txp_len, group)
                builder.add_filtered_group(fg)
            group = []
            prev = rec.name
        if rec.ref_id >= 0:
            group.append(rec)
    if group:
        fg = filter_group(opts, builder.discard, txp_len, group)
        builder.add_filtered_group(fg)
    return builder.finalize(), coverage


def _ceil_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _bucket_cost(key) -> int:
    """Per-cell per-iteration work of a bucket shape: the dense
    formulation multiplies the S [a,t] and R [r,a] incidence matrices (the
    segsum path's element count scales the same way)."""
    a, r, t = key
    return a * t + r * a


def coarsen_buckets(buckets: Dict[tuple, "CellBatch"],
                    max_buckets: int = 12) -> Dict[tuple, "CellBatch"]:
    """Merge pow2 size buckets until at most `max_buckets` distinct
    shapes remain. Greedy: repeatedly take the bucket with the smallest
    total padded work and move its cells into the existing bucket that
    dominates it on all three dims at the least added per-cell cost; if
    none dominates, merge with the cheapest elementwise-max partner. Pure
    repacking: cell contents and EM semantics are untouched.
    OARFISH_SC_MAX_BUCKETS overrides."""
    env = os.environ.get("OARFISH_SC_MAX_BUCKETS")
    if env is not None:
        max_buckets = max(1, int(env))
    while len(buckets) > max_buckets:
        # victim: least total padded work (cheapest to re-pad upward)
        victim = min(
            buckets,
            key=lambda k: _bucket_cost(k) * len(buckets[k].cell_index),
        )
        dom = [
            k for k in buckets
            if k != victim and all(x >= y for x, y in zip(k, victim))
        ]
        if dom:
            target = min(dom, key=_bucket_cost)
        else:
            others = [k for k in buckets if k != victim]
            target = min(
                others,
                key=lambda k: _bucket_cost(
                    tuple(max(x, y) for x, y in zip(k, victim))
                ) * (len(buckets[k].cell_index)
                     + len(buckets[victim].cell_index)),
            )
        merged = tuple(max(x, y) for x, y in zip(target, victim))
        vb, tb = buckets.pop(victim), buckets.pop(target)
        nb = buckets.get(merged)
        if nb is None:
            nb = buckets[merged] = CellBatch(*merged, tb.t_global)
        for b in (tb, vb):
            for i in range(len(b.cell_index)):
                nb.add(b.cell_index[i], b.txp_local[i], b.weights[i],
                       b.read_id[i], b.num_reads[i], b.global_ids[i])
    return buckets


def sc_impl(device: torch.device) -> str:
    """`OARFISH_SC_IMPL` (auto, dense, segsum); `auto` is `segsum` on the
    CPU and `dense` on the card, the JAX package's rule read off the run's
    device."""
    impl = os.environ.get("OARFISH_SC_IMPL", "auto")
    if impl not in SC_IMPLS:
        raise ValueError(f"OARFISH_SC_IMPL={impl!r}: use one of {SC_IMPLS}")
    if impl == "auto":
        impl = "segsum" if device.type == "cpu" else "dense"
    return impl


class CellBatch:
    """One size bucket of cells, padded and stacked for a batched EM."""

    def __init__(self, a_pad: int, r_pad: int, t_pad: int, t_global: int):
        self.a_pad, self.r_pad, self.t_pad = a_pad, r_pad, t_pad
        self.t_global = t_global
        self.txp_local: List[np.ndarray] = []
        self.weights: List[np.ndarray] = []
        self.read_id: List[np.ndarray] = []
        self.num_reads: List[int] = []
        self.global_ids: List[np.ndarray] = []
        self.cell_index: List[int] = []

    @property
    def key(self) -> Tuple[int, int, int]:
        return self.a_pad, self.r_pad, self.t_pad

    def add(self, cell_index, txp_local, w, read_id, num_reads, global_ids):
        self.txp_local.append(txp_local)
        self.weights.append(w)
        self.read_id.append(read_id)
        self.num_reads.append(num_reads)
        self.global_ids.append(global_ids)
        self.cell_index.append(cell_index)

    def part(self, lo: int, hi: int) -> "CellBatch":
        """Cells `lo` to `hi - 1` of this bucket, at its padded shapes."""
        out = CellBatch(self.a_pad, self.r_pad, self.t_pad, self.t_global)
        for name in ("txp_local", "weights", "read_id", "num_reads",
                     "global_ids", "cell_index"):
            setattr(out, name, getattr(self, name)[lo:hi])
        return out

    def run(self, args: Args, dtype: torch.dtype, devices):
        """The bucket's batched EM, its cells cut into one contiguous part
        per device of `devices` (one part: the whole bucket); returns per
        cell (cell index, global transcript ids, counts) in bucket order,
        on the host. Each part's counts cross to the host once, at the
        end."""
        B = len(self.cell_index)
        D = min(len(devices), B)
        cuts = [(B * d) // D for d in range(D + 1)]
        counts, subs = [], []
        impl = sc_impl(devices[0])
        with trace.span("cells.bucket", cells=B, impl=impl) as bucket:
            for d in range(D):
                part = self if D == 1 else self.part(cuts[d], cuts[d + 1])
                if impl == "dense":
                    c, sub = part._run_dense(args, dtype, devices[d])
                else:
                    c, sub = part._run_segsum(args, dtype, devices[d])
                counts.append(c.double().cpu().numpy())
                subs.append((len(part.cell_index), sub))
        counts = np.concatenate(counts)
        n_sub = sum(-(-n // sub) for n, sub in subs)
        log.info("sc bucket %s: %d cells, %s, %d sub-batches of at most "
                 "%d, %.3fs", self.key, B, impl, n_sub,
                 max(sub for _, sub in subs), bucket.seconds)
        return [
            (self.cell_index[i], self.global_ids[i],
             counts[i, : len(self.global_ids[i])])
            for i in range(B)
        ]

    def _run_segsum(self, args: Args, dtype, device):
        """The bucket as one flattened CSR through the segment-sum m-step
        (`[B, t_pad + 1]` counts, one batch)."""
        B = len(self.txp_local)
        a_p, r_p, t_p = self.a_pad, self.r_pad, self.t_pad
        # padding: dummy alignments with w=0 on a dummy read (r_p) and a
        # dummy transcript slot (t_p); dummy reads get denom 0 -> dropped
        txp = np.full((B, a_p), t_p, dtype=np.int64)
        wts = np.zeros((B, a_p), dtype=np.float64)
        rid = np.full((B, a_p), r_p, dtype=np.int64)
        for i in range(B):
            a = len(self.txp_local[i])
            txp[i, :a] = self.txp_local[i]
            wts[i, :a] = self.weights[i]
            rid[i, :a] = self.read_id[i]
        cells = np.arange(B, dtype=np.int64)[:, None]
        data = EmData.build(
            (txp + cells * (t_p + 1)).ravel(), wts.ravel(),
            (rid + cells * (r_p + 1)).ravel(), B * (r_p + 1),
            B * (t_p + 1), dtype=dtype, device=device,
        )
        # uniform init avg = R_cell / T_global (`em.rs:164-166` with the
        # cell's read count over the FULL transcriptome size)
        init = np.repeat(
            np.asarray(self.num_reads, dtype=np.float64)[:, None]
            / self.t_global, t_p + 1, axis=1)
        init = torch.as_tensor(init, device=device).to(dtype)

        def m_step(prev):
            return _m_step(data, prev.reshape(-1), None).reshape(prev.shape)

        if args.em_accel == "squarem":
            counts, _ = squarem_em(m_step, init, args.max_em_iter,
                                   args.convergence_thresh)
        else:
            prev, _ = em_loop(m_step, init, args.max_em_iter,
                              args.convergence_thresh)
            counts = finish_em(m_step, prev)
        return counts, B

    def _dense_sub_batch(self) -> int:
        """Cells per dense sub-batch under a device-memory budget: the
        one-hot matrices scale as B*(a_pad*t_pad + r_pad*a_pad), so a
        populous bucket run as one batch would not fit. ~8 bytes/element
        covers the matrices in the compute dtype and the temporaries.
        OARFISH_SC_DENSE_BUDGET_MB overrides (default 1024)."""
        budget = int(
            os.environ.get("OARFISH_SC_DENSE_BUDGET_MB", "1024")
        ) << 20
        per_cell = 8 * (
            self.a_pad * self.t_pad + self.r_pad * self.a_pad
        )
        return max(1, budget // max(per_cell, 1))

    def _run_dense(self, args: Args, dtype, device):
        """The dense one-hot formulation, in sub-batches under the budget
        (`[B, t_pad]` counts)."""
        B = len(self.txp_local)
        sub = min(B, self._dense_sub_batch())
        data = DenseCellEm.build(
            self.txp_local, self.weights, self.read_id,
            self.a_pad, self.r_pad, self.t_pad, dtype=dtype, device=device,
        )
        # uniform init = R_cell / T_global, made on the device from the
        # per-cell read counts
        nr = torch.as_tensor(
            np.asarray(self.num_reads, dtype=np.float64), device=device
        ).to(dtype)
        init = (nr / float(self.t_global))[:, None].expand(B, self.t_pad)
        counts, _ = run_em_dense_scan(
            data, init, sub, args.max_em_iter, args.convergence_thresh,
            accel=args.em_accel == "squarem",
        )
        return counts, sub


def _add_cell(buckets, T, cell_index, txp, w, read_id, num_reads) -> None:
    """Relabel a cell to a dense local transcript space and file it under
    its size bucket."""
    global_ids, local = np.unique(txp, return_inverse=True)
    key = (
        _ceil_pow2(len(txp)),
        _ceil_pow2(num_reads),
        _ceil_pow2(len(global_ids)),
    )
    batch = buckets.get(key)
    if batch is None:
        batch = buckets[key] = CellBatch(*key, T)
    batch.add(cell_index, local.astype(np.int32), w, read_id, num_reads,
              global_ids)


def _iter_cells_native(args: Args, opts: FilterOpts):
    """Fast path: C++ columnar decode + whole-file vectorized filtering,
    then per-cell CSR slices. Yields (header, iterator of
    (barcode, txp_id, start, end, prob, boundaries)). With the coverage
    model on, the caller builds the per-cell binomial model from the
    (post-filter) slices — identical bins to the streaming path."""
    from ..host import native
    from ..host.vector_filter import filter_records

    dec = native.decode_bam(
        args.alignments,
        threads=max(args.threads - 1, 1),
        sort_check_num=args.sort_check_num,
        want_barcodes=True,
    )
    if dec is None:
        return None
    if dec.cb_id is None or (len(dec.cb_id) and (dec.cb_id < 0).any()):
        raise ValueError("could not get CB tag value")
    header = dec.header
    cols = dec.columns
    txps_len = np.asarray(header.ref_lengths, dtype=np.int64)

    # reorder records within each name group: primary before secondary
    # (`sort_and_parse_barcode_records`, `alignment_parser.rs:180-191`)
    secondary = ((cols.flag & 0x100) != 0).astype(np.int8)
    order = np.lexsort((secondary, cols.group_id))
    for f in ("group_id", "flag", "ref_id", "pos", "ref_span", "seq_len",
              "score", "has_score"):
        setattr(cols, f, getattr(cols, f)[order])
    cb_sorted = dec.cb_id[order]

    packed = filter_records(opts, txps_len, cols)

    # cell = contiguous run of one barcode (a re-appearing barcode starts a
    # new row, like the reference's peel loop, `single_cell.rs:200-227`)
    G = cols.num_groups
    cb_of_group = np.full(G, -1, dtype=np.int64)
    cb_of_group[cols.group_id[::-1]] = cb_sorted[::-1]
    cbs = cb_of_group
    run_of_group = np.zeros(G, dtype=np.int64)
    if G:
        changes = np.ones(G, dtype=bool)
        changes[1:] = cbs[1:] != cbs[:-1]
        run_of_group = np.cumsum(changes) - 1
    # barcode of each run = the (constant) barcode of its first group
    n_runs = int(run_of_group[-1]) + 1 if G else 0
    first_g = np.nonzero(changes)[0] if G else np.empty(0, np.int64)
    run_cb = cbs[first_g] if G else np.empty(0, np.int64)

    def cells():
        # reads arrive in group order and run ids are non-decreasing in
        # group order, so every run is a contiguous read range whose
        # alignments are a contiguous CSR slice
        rows_run = run_of_group[packed.group_of_read]
        assert len(rows_run) == 0 or (np.diff(rows_run) >= 0).all(), (
            "reads not in run order; grouping invariant broken"
        )
        starts = np.searchsorted(
            rows_run, np.arange(n_runs + 1, dtype=np.int64)
        )
        for r in range(n_runs):
            lo, hi = int(starts[r]), int(starts[r + 1])
            cb = int(run_cb[r]) if r < len(run_cb) else -1
            bc = dec.barcodes[cb] if cb >= 0 else ""
            if hi == lo:
                yield bc, None
                continue
            alo = int(packed.boundaries[lo])
            ahi = int(packed.boundaries[hi])
            b = packed.boundaries[lo : hi + 1] - alo
            yield bc, (
                packed.txp_id[alo:ahi],
                packed.start[alo:ahi],
                packed.end[alo:ahi],
                packed.prob[alo:ahi],
                b,
            )

    return header, cells()


def quantify_single_cell_from_collated_bam(args: Args, opts: FilterOpts):
    """`--single-cell`: returns the number of cells. One device only; the
    device is resolved (and its absence raised) before the input is
    opened."""
    from ..host import native

    device = resolve_device(args.device)
    dtype = resolve_em_dtype(args.em_dtype, device)
    if native.available():
        return _quantify_single_cell_native(args, opts, device, dtype)
    return _quantify_single_cell_streaming(args, opts, device, dtype)


def _quantify_single_cell_native(args: Args, opts: FilterOpts, device,
                                 dtype):
    from ..utils.progress import Progress

    header, cell_iter = _iter_cells_native(args, opts)
    verify_header(header, args.alignments)
    txps_name = header.ref_names
    txps_len = np.asarray(header.ref_lengths, dtype=np.int64)
    T = len(txps_name)
    digest = {"bam_digest": LazyDigest(digest_from_header, txps_name, txps_len)}

    with trace.span("sc.parse") as parse:
        barcodes: List[str] = []
        buckets: Dict[Tuple[int, int, int], CellBatch] = {}
        num_cells = 0
        skipped_empty = 0
        reads = 0
        prog = Progress("packing cells", unit="cells")
        for bc, cell in cell_iter:
            prog.update()
            barcodes.append(bc)
            idx_cell = num_cells
            num_cells += 1
            if cell is None:
                skipped_empty += 1
                continue
            txp, start, end, prob, b = cell
            if opts.model_coverage:
                # per-cell binomial coverage model over the retained
                # alignments (the reference builds a fresh per-cell model,
                # `single_cell.rs:132-137`); slices are post-filter so the
                # bins match the streaming path exactly
                cov = TranscriptCoverage(txps_len, args.bin_width)
                cov.add_intervals(txp, start, end)
                cell_store = AlignmentStore(
                    txp_id=txp.astype(np.int32), start=start, end=end,
                    as_prob=prob.astype(np.float32),
                    cov_prob=np.zeros(len(txp)), boundaries=b,
                    discard=DiscardTable(),
                )
                flat = binomial_continuous_prob(cov)
                normalize_read_probs(cell_store, cov, flat, args.bin_width)
                w = cell_store.as_prob.astype(np.float64) * cell_store.cov_prob
            else:
                w = prob.astype(np.float64)
            n_reads = len(b) - 1
            reads += n_reads
            rid = np.repeat(np.arange(n_reads, dtype=np.int32), np.diff(b))
            _add_cell(buckets, T, idx_cell, txp, w, rid, n_reads)
            if num_cells % 100 == 0:
                log.info("Processed %d cells.", num_cells)

        prog.close()
        buckets = _parsed(buckets, num_cells, skipped_empty, reads,
                          parse)
    return _finish_single_cell(args, buckets, barcodes, num_cells,
                               txps_name, digest, dtype, device)


def _quantify_single_cell_streaming(args: Args, opts: FilterOpts, device,
                                    dtype):
    from ..utils.progress import Progress

    reader = BamReader(args.alignments, threads=max(args.threads - 1, 1))
    verify_header(reader.header, args.alignments)
    txps_name = reader.header.ref_names
    txps_len = np.asarray(reader.header.ref_lengths, dtype=np.int64)
    T = len(txps_name)
    digest = {"bam_digest": LazyDigest(digest_from_header, txps_name, txps_len)}

    with trace.span("sc.parse") as parse:
        barcodes: List[str] = []
        buckets: Dict[Tuple[int, int, int], CellBatch] = {}
        num_cells = 0
        skipped_empty = 0
        reads = 0

        prog = Progress("packing cells", unit="cells")
        for barcode, records in iter_barcode_groups(reader.records()):
            prog.update()
            store, coverage = build_cell_store(records, txps_len, opts,
                                               args.bin_width)
            barcodes.append(barcode.decode("ascii", "replace"))
            if store.num_reads == 0:
                # the reference still runs the EM (yielding all-zero
                # counts) and writes the barcode row; we record the
                # barcode with no entries
                num_cells += 1
                skipped_empty += 1
                continue
            if opts.model_coverage:
                flat = binomial_continuous_prob(coverage)
                normalize_read_probs(store, coverage, flat, args.bin_width)
                w = store.as_prob.astype(np.float64) * store.cov_prob
            else:
                w = store.as_prob.astype(np.float64)
            reads += store.num_reads
            _add_cell(buckets, T, num_cells, store.txp_id, w, store.read_ids(),
                      store.num_reads)
            num_cells += 1
            if num_cells % 100 == 0:
                log.info("Processed %d cells.", num_cells)

        prog.close()
        buckets = _parsed(buckets, num_cells, skipped_empty, reads,
                          parse)
    return _finish_single_cell(args, buckets, barcodes, num_cells,
                               txps_name, digest, dtype, device)


def cell_devices(args: Args, device: torch.device) -> list:
    """The devices the cell batches are spread over (the JAX package's
    `_cell_mesh`): with `--num-shards D > 1` the first min(D, cards)
    cards, else (and on the CPU) `device` alone."""
    if args.num_shards <= 1 or device.type == "cpu":
        return [device]
    D = min(args.num_shards, torch.cuda.device_count())
    if D <= 1:
        return [device]
    log.info("single-cell EM batches sharded over %d devices", D)
    return [torch.device("cuda", i) for i in range(D)]


def _parsed(buckets, num_cells, skipped_empty, reads, parse: trace.Span):
    """The buckets of the span `parse` coarsened, and its log line."""
    n_raw = len(buckets)
    buckets = coarsen_buckets(buckets)
    log.info(
        "parsed %d cells (%d with no surviving alignments, %d reads kept) "
        "in %s; %d size buckets (%d before coarsening)",
        num_cells, skipped_empty, reads, humantime(time.time() - parse.start),
        len(buckets), n_raw,
    )
    return buckets


def _finish_single_cell(args, buckets, barcodes, num_cells, txps_name,
                        digest, dtype, device):
    """The cells' EMs (the span `sc.em`) and the writers (`sc.write`)."""
    devices = cell_devices(args, device)
    row_parts: List[np.ndarray] = []
    col_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    with trace.span("sc.em") as em:
        # one bucket at a time, in sorted-key order: each bucket's device
        # tensors are freed before the next bucket is built
        for key in sorted(buckets):
            for cell_index, gids, counts in buckets.pop(key).run(
                    args, dtype, devices):
                nz = counts > 0.0
                n = int(np.count_nonzero(nz))
                if n == 0:
                    continue
                row_parts.append(np.full(n, cell_index, dtype=np.int64))
                col_parts.append(np.asarray(gids[nz], dtype=np.int64))
                val_parts.append(counts[nz].astype(np.float32))
        empty64 = np.empty(0, np.int64)
        rows = np.concatenate(row_parts) if row_parts else empty64
        cols = np.concatenate(col_parts) if col_parts else empty64
        vals = (np.concatenate(val_parts) if val_parts
                else np.empty(0, np.float32))
    log.info("ran %d cell EMs on %s (%s) in %s", num_cells, device,
             str(dtype).replace("torch.", ""), humantime(em.seconds))

    with trace.span("sc.write"):
        _write(args, txps_name, barcodes, rows, cols, vals, num_cells,
               digest)
    return num_cells


def _write(args, txps_name, barcodes, rows, cols, vals, num_cells,
           digest) -> None:
    info = {
        "prob_model": "logistic_coverage" if args.model_coverage else "no_coverage",
        "bin_width": args.bin_width,
        "alignments": str(args.alignments),
        "output": str(args.output),
        "verbose": args.verbose,
        "single_cell": True,
        "quiet": args.quiet,
        "em_max_iter": args.max_em_iter,
        "em_convergence_thresh": args.convergence_thresh,
        "threads": args.threads,
        "filter_group": None,
        "short_quant": args.short_quant,
        "digest": resolve_lazy_digests(digest),
    }
    write_single_cell_output(
        args.output,
        info,
        txps_name,
        barcodes,
        rows,
        cols,
        np.asarray(vals, dtype=np.float32),
        num_cells,
    )
