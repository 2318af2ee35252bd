"""EM v4: the dual-bucketed, fully-static-routed iteration.

Counterpart of the JAX package's `ops/em_v4.py`. The host half (bucket
layouts, slot maps, route geometry, level table) is that module's, so both
packages build identical plans; the device half is rewritten for torch
tensors and the hand-written kernels of `tile_permute.py`,
`route_stage.py` and `route_middle.py`.

BOTH reductions of an EM iteration are dense row sums over bucketed
layouts, connected by two static permutations:

  prev[T] --tiny tile permute--> per-transcript-row values
          --row broadcast--> prev_slots ; contrib_t = prev_slots * w_txp
  contrib_t --P_A--> read-bucket layout
  read-row sums -> denom -> scale -> row broadcast
  inc = contrib_read * scale_slots
  inc --P_B--> transcript-bucket layout
  txp-row sums (+ second level for chunked hot transcripts)
          --tiny tile permute--> curr[T]

No data-dependent gathers, no scatters, no cumsums over the alignment
space, and no float atomics: the whole iteration is row reductions,
broadcasts, elementwise products, and four static permutation networks
(`static_permute`), so a second run is bit-identical.

Layout: buckets are stored COLUMN-MAJOR within groups of 128 rows (the
slot of (row i, position j) is `start + (i//128)*K*128 + j*128 + i%128`),
so every reduction and broadcast is over a `[groups, K, 128]` view. Row
counts are padded to multiples of 128 with all-zero rows.

Transcripts with more than CAPK alignments are chunked over consecutive
CAPK-wide rows and their row sums reduced in a tiny static second
level, keeping the bucket padding ~10% instead of the up-to-2x of pure
power-of-two rounding.

Semantics match the reference serial EM (`em.rs:87-255`) exactly as
`em_fast` does. The kernels are bit-equal to their plain versions. The
glue's sums (the bucket row sums, the big-transcript second level and the
zero pad, one launch an m-step: `EmV4Data.tail_plan`) go through the
row-sum kernel of `row_sums.py`, which adds each row in XLA's CPU order
whatever the replicates around it: a replicate of a batch is
bit-equal to the same replicate alone, and the bucket sums equal the JAX
package's. The second level adds row sums where the JAX package takes
differences of a `cumsum`, and the routes' stages add in their own order,
so a whole EM agrees with the JAX package's to tolerance.

A batch of bootstrap replicates is one program: the glue takes a leading
replicate axis and `_m_step_v4_batch` sends all replicates through one
launch of each kernel (the replicate arms of `route_stage.py` and
`route_middle.py`), on a layout with the fused middle and the strided
exchange. The JAX package keeps that arm behind a switch and batches with
`vmap` otherwise; here it is taken wherever it applies, and any other
layout runs the replicates one after another (`_m_step_v4_b`). The
counterparts of `run_em_v4_batch` / `run_em_v4_batch_squarem` are
`run_em_v4` / `run_em_v4_squarem` with `init` `[B, T]`.

`V4Prebuild` takes the layout's A-sized inputs from the pack's chunks as
they land (`_v4_layout(pre=...)`), and `EmV4Data.build` takes a plan
read during the pack (`plan_cache.Prefetch`) and writes the BAM's pointer
file; neither changes a bit of the layout.

`compute_envelope` / `merge_envelopes` and the `envelope=` arm of
`_v4_layout` give the shards of a sharded build (`parallel/sharded_v4.py`)
one set of bucket shapes and one `t_space`; `_v4_finish(geometry=...)`
one route geometry.

Not ported: the canonical-shape code, the rectangular rebuild,
the environment switches of the JAX package's A/B work (each one's
default is taken), and the sub-batches of four replicates that fit
another memory budget.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import EM_DENOM_THRESH
from ..device import resolve_device
from ..utils import trace
from . import balance as _balance
from . import plan_cache
from .em import BatchStep, em_loop, finish_em, squarem_loop
from .route_middle import route_middle
from .row_sums import RowSumPlan, RowSumTable, bucket_table, row_sums
from .static_permute import (
    CH,
    LANES,
    BatchTilePermute,
    DeviceTilePlan,
    GlobalRoutePlan,
    build_route_pair_async,
    route_maxflow,
    select_route_geometry,
)

log = logging.getLogger("oarfish_tpu_torch")

CAPK = 2048  # max bucket row width; wider transcripts are row-chunked


def _pad128(n: int) -> int:
    return ((n + LANES - 1) // LANES) * LANES


def _pow2_buckets(sizes: np.ndarray, shuffle_rng, buckets=None,
                  align_groups: bool = False):
    """Group rows (reads or transcripts) by power-of-two size buckets
    (bucket K holds sizes in (K//2, K]). Returns
    (shapes, starts, row_parts, n_slots): shapes hold the 128-PADDED row
    count per bucket; row_parts the true member ids (shuffled within
    buckets, which decorrelates the route flows). Size-0 rows are
    excluded.

    With `align_groups` each bucket start is aligned to K*128 (its own
    group span), so no 128-row group ever straddles a route-chunk
    boundary — the invariant the fused middle kernel's in-chunk row
    sums rely on (read side only; total waste < sum K*128 ~ tens of KB).

    With `buckets` (a ((K, rows_pad), ...) envelope shared by the shards of
    a sharded build, see `merge_envelopes`) the bucket list and padded row
    counts are forced, possibly larger than this dataset needs; the extra
    rows are dead (their slots stay all-zero)."""
    if buckets is None:
        maxk = int(sizes.max()) if len(sizes) else 1
        ks: List[int] = []
        K = 1
        while K < maxk:
            ks.append(K)
            K *= 2
        ks.append(max(K, 1))
        buckets = []
        lo = 0
        for K in ks:
            n = int(np.count_nonzero((sizes > lo) & (sizes <= K)))
            lo = K
            if n:
                buckets.append((K, _pad128(n)))
    shapes = []
    starts = []
    row_parts = []
    n_slots = 0
    for K, rows_pad in buckets:
        lo = K // 2
        rows = np.nonzero((sizes > lo) & (sizes <= K))[0]
        assert _pad128(len(rows)) <= rows_pad
        rows = shuffle_rng.permutation(rows)
        if align_groups:
            span = K * LANES
            n_slots = ((n_slots + span - 1) // span) * span
        starts.append(n_slots)
        shapes.append((int(rows_pad), int(K)))
        row_parts.append(rows)
        n_slots += rows_pad * K
    return shapes, starts, row_parts, n_slots


_POW2 = 1 << np.arange(63, dtype=np.int64)


def _pow2_buckets_pre(class_rows: dict, max_size: int, shuffle_rng,
                      buckets=None, align_groups: bool = False):
    """`_pow2_buckets` from prebuilt per-class member lists (ascending
    ids: the chunk-incremental path). Mirrors `_pow2_buckets` exactly,
    including the order in which it draws from `shuffle_rng` and the
    `buckets` envelope, so the layout is bit-identical to the monolithic
    build."""
    if buckets is None:
        maxk = max(int(max_size), 1)
        ks: List[int] = []
        K = 1
        while K < maxk:
            ks.append(K)
            K *= 2
        ks.append(max(K, 1))
        buckets = [
            (K, _pad128(len(class_rows[K])))
            for K in ks
            if len(class_rows.get(K, ())) > 0
        ]
    shapes = []
    starts = []
    row_parts = []
    n_slots = 0
    empty = np.empty(0, dtype=np.int64)
    for K, rows_pad in buckets:
        rows = class_rows.get(K, empty)
        assert _pad128(len(rows)) <= rows_pad
        rows = shuffle_rng.permutation(rows)
        if align_groups:
            span = K * LANES
            n_slots = ((n_slots + span - 1) // span) * span
        starts.append(n_slots)
        shapes.append((int(rows_pad), int(K)))
        row_parts.append(rows)
        n_slots += rows_pad * K
    return shapes, starts, row_parts, n_slots


class V4Prebuild:
    """Chunk-incremental precomputation of the v4 layout's A-sized
    inputs, overlapped with the streaming pack.

    As filtered CSR chunks land (`host/packer.py`'s `chunk_observer`), a
    worker thread accumulates, off the critical path after the pack:
      - per-transcript alignment counts (a running bincount),
      - each alignment's rank within its transcript (chunk-local counting
        sort rank plus the running count),
      - the reads' power-of-two size-class member lists (a read's class is
        final when its chunk lands: groups never straddle chunks).
    `_v4_layout(pre=...)` then skips its own rank, read-bucket and
    bincount passes. The layout is bit-identical to the monolithic one.
    The worker is a Python thread of NumPy work."""

    def __init__(self, queue_depth: int = 8):
        self.counts = np.zeros(1024, dtype=np.int64)
        self.rank_chunks: List[np.ndarray] = []
        self.class_rows: dict = {}
        self.read_off = 0
        self.aln_off = 0
        self.max_size = 0
        self._err: Optional[BaseException] = None
        self._quiet = False
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def observe(self, packed) -> None:
        """Hand over one packed chunk (`txp_id`, `boundaries`); called on
        the pack's consumer thread."""
        if self._err is None:
            self._q.put((packed.txp_id, np.diff(packed.boundaries)))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue  # drain
            try:
                self._ingest(*item)
            except BaseException as e:  # noqa: BLE001 - monolithic build
                self._err = e

    def _ingest(self, txp_id: np.ndarray, sizes: np.ndarray) -> None:
        t64 = np.ascontiguousarray(txp_id, dtype=np.int64)
        if len(t64):
            tmax = int(t64.max())
            if tmax >= len(self.counts):
                grown = np.zeros(
                    max(tmax + 1, 2 * len(self.counts)), dtype=np.int64
                )
                grown[: len(self.counts)] = self.counts
                self.counts = grown
            rk = _balance.rank_by_key(t64, len(self.counts))
            if rk is not None:
                local_rank = rk[1]
            else:
                ordc = np.argsort(t64, kind="stable")
                cc = np.bincount(t64, minlength=len(self.counts))
                rs = np.zeros(len(cc) + 1, dtype=np.int64)
                np.cumsum(cc, out=rs[1:])
                lr = np.arange(len(t64), dtype=np.int64) - rs[t64[ordc]]
                local_rank = np.empty(len(t64), dtype=np.int64)
                local_rank[ordc] = lr
            self.rank_chunks.append(local_rank + self.counts[t64])
            self.counts[: tmax + 1] += np.bincount(t64, minlength=tmax + 1)
        sizes = np.asarray(sizes, dtype=np.int64)
        if len(sizes):
            self.max_size = max(self.max_size, int(sizes.max()))
            cls = np.searchsorted(_POW2, sizes, side="left")
            for c in np.unique(cls):
                K = int(_POW2[c])
                ids = self.read_off + np.nonzero(cls == c)[0]
                self.class_rows.setdefault(K, []).append(ids)
        self.read_off += len(sizes)
        self.aln_off += len(t64)

    def finish(self, num_txps: int) -> Optional[dict]:
        """Join the worker and assemble the layout inputs; None when
        ingestion failed or was aborted (the caller builds
        monolithically)."""
        self._q.put(None)
        self._th.join()
        if self._err is not None:
            if not self._quiet:
                log.warning("v4 prebuild failed (%s); building "
                            "monolithically", self._err)
            return None
        if len(self.counts) < num_txps:
            grown = np.zeros(num_txps, dtype=np.int64)
            grown[: len(self.counts)] = self.counts
            self.counts = grown
        empty = np.empty(0, dtype=np.int64)
        return {
            "counts": self.counts[:num_txps],
            "rank": (
                np.concatenate(self.rank_chunks)
                if self.rank_chunks
                else empty
            ),
            "classes": {
                K: np.concatenate(parts)
                for K, parts in self.class_rows.items()
            },
            "max_size": self.max_size,
            "A": self.aln_off,
            "R": self.read_off,
        }

    def abort(self, quiet: bool = False) -> None:
        """Stop taking chunks; `finish` then returns None (with a warning
        unless `quiet`)."""
        self._quiet = self._quiet or quiet
        self._err = self._err or RuntimeError("aborted")
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass


def _colmajor_slot(start: int, K: int, row, col):
    """Flat slot of (bucket row, position) in the column-major layout."""
    return start + (row >> 7) * (K << 7) + (col << 7) + (row & 127)


def _tile_rows(n: int) -> int:
    """Smallest row count (multiple of 128) whose [rows,128] tile holds n."""
    rows = (n + LANES - 1) // LANES
    return ((rows + LANES - 1) // LANES) * LANES


def compute_envelope(txp_id, boundaries, num_txps) -> dict:
    """Static-shape requirements of this dataset's v4 layout. Merging
    envelopes across read shards (`merge_envelopes`) and passing the
    result to every shard's layout (`_v4_layout(envelope=...)`) gives all
    shards the same buckets, big-transcript rows and `t_space`, so their
    partial counts add element by element (`parallel/sharded_v4.py`)."""
    sizes = np.diff(np.asarray(boundaries, dtype=np.int64))
    counts = np.bincount(
        np.asarray(txp_id, dtype=np.int64), minlength=num_txps
    )

    def ladder(szs):
        maxk = int(szs.max()) if len(szs) else 1
        out = []
        K = 1
        lo = 0
        while True:
            n = int(np.count_nonzero((szs > lo) & (szs <= K)))
            if n:
                out.append((K, _pad128(n)))
            if K >= maxk:
                break
            lo = K
            K *= 2
        return tuple(out)

    read_buckets = ladder(sizes)
    small = np.where((counts > 0) & (counts <= CAPK), counts, 0)
    small_buckets = ladder(small) if small.any() else ()
    big = counts[counts > CAPK]
    n_big = int(len(big))
    big_rows = int(np.ceil(big / CAPK).sum()) if n_big else 0
    row_space_s = sum(rp for _, rp in small_buckets)
    t_rows = _tile_rows(max(num_txps, row_space_s + n_big, 1))
    return {
        "read_buckets": read_buckets,
        "small_buckets": small_buckets,
        "big_rows_pad": _pad128(big_rows),
        "n_big": n_big,
        "t_rows": t_rows,
    }


def merge_envelopes(envs: List[dict]) -> dict:
    """Pointwise max of per-shard envelopes (union of bucket Ks, max
    padded rows per K)."""

    def merge_buckets(key):
        acc = {}
        for e in envs:
            for K, rp in e[key]:
                acc[K] = max(acc.get(K, 0), rp)
        return tuple(sorted(acc.items()))

    return {
        "read_buckets": merge_buckets("read_buckets"),
        "small_buckets": merge_buckets("small_buckets"),
        "big_rows_pad": max(e["big_rows_pad"] for e in envs),
        "n_big": max(e["n_big"] for e in envs),
        "t_rows": max(e["t_rows"] for e in envs),
    }


@dataclass(frozen=True)
class EmV4Data:
    """Static device state for the dual-bucketed EM."""

    w_txp: torch.Tensor  # [n_src*CR*128] weights in txp-bucket layout (pads 0)
    p_a: GlobalRoutePlan  # txp layout -> read layout
    p_b: GlobalRoutePlan  # read layout -> txp layout
    t_in: BatchTilePermute  # prev[T] -> per-row / per-big values
    t_out: BatchTilePermute  # row sums -> curr[T]
    big_row_of_txp: torch.Tensor  # [big_rows_pad] i64: big-txp idx per row
    big_row_offsets: torch.Tensor  # [n_big+1] i64 row ranges per big txp
    seg_id: Optional[torch.Tensor]  # [n_chunks*CR, 128] i8 log2(K) per row
    t_row_src: torch.Tensor  # [n_src*CR] i64: `_row_sources`, txp layout
    r_row_src: torch.Tensor  # [n_dst*CR] i64: `_row_sources`, read layout
    read_shapes: Tuple[Tuple[int, int], ...]  # (rows_pad, K)
    read_starts: Tuple[int, ...]
    n_slots_r: int
    row_space_r: int
    small_shapes: Tuple[Tuple[int, int], ...]
    small_starts: Tuple[int, ...]
    row_space_s: int
    big_rows_pad: int
    n_big: int
    n_slots_t: int
    t_space: int
    num_reads: int
    num_txps: int

    @property
    def device(self) -> torch.device:
        return self.w_txp.device

    @property
    def txp_buckets(self):
        return txp_buckets(self.small_shapes, self.small_starts,
                           self.big_rows_pad, self.n_slots_t)

    @cached_property
    def txp_sum_table(self) -> RowSumTable:
        """Row sums of the transcript layout: the small buckets' rows,
        then the big region's (`row_space_s + big_rows_pad` outputs)."""
        return bucket_table(*self.txp_buckets, self.device)

    @cached_property
    def tail_plan(self) -> RowSumPlan:
        """The transcript tail as one launch: the small buckets' row sums,
        each big transcript's consecutive rows of the big region added
        again (the second level), zeros to `t_space`: the vector that
        `t_out` takes. The big transcripts that a sharded build's envelope
        adds own no rows and come last: their sums are left to the zeros."""
        o = self.big_row_offsets.cpu().numpy()
        o = o[: np.searchsorted(o, o[-1]) + 1]
        return RowSumPlan.make(self.txp_sum_table, n_out=self.t_space,
                               first=self.row_space_s, offsets=o)

    @cached_property
    def read_sum_table(self) -> RowSumTable:
        """Row sums of the read layout (the unfused middle's
        denominators)."""
        return bucket_table(self.read_shapes, self.read_starts, self.device)

    @property
    def max_lvl(self) -> int:
        return max(
            (int(K).bit_length() - 1 for _rp, K in self.read_shapes),
            default=0,
        )

    @staticmethod
    def build(
        txp_id: np.ndarray,
        weights: np.ndarray,
        boundaries: np.ndarray,
        num_txps: int,
        dtype: torch.dtype = torch.float32,
        device=None,
        pre: Optional[dict] = None,
        prefetch=None,
        pointer_key: Optional[str] = None,
    ) -> Tuple["EmV4Data", np.ndarray]:
        """Build the routed device state; returns (data, read_order), where
        `read_order[i]` is the original read of padded bucket row i
        (multiplicity vectors are given in that order). `device=None` is
        the package default (`cuda`; raises without a card), `"cpu"` is the
        host on request. The build's two phases are the spans `v4.layout`
        and `v4.finish` (`utils/trace.py`), each phase's steps their laps.

        The layout and the route tables depend only on the CSR structure,
        so they are kept in the persistent plan cache (`plan_cache.py`):
        re-quantifying the same alignments skips the whole build, and the
        weights re-enter through one `w_txp` scatter. Raises `ValueError`
        when no route geometry is feasible (too few alignments).

        `pre` (from `V4Prebuild.finish`) supplies the layout's A-sized
        inputs, computed during the pack; `prefetch` (a
        `plan_cache.Prefetch`) an entry read during the pack, used when its
        key is this CSR's; `pointer_key` names the BAM pointer file to
        write on a hit and after a store."""
        device = resolve_device(device)
        cache_key = None
        if plan_cache.enabled():
            cache_key = plan_cache.layout_key(txp_id, boundaries, num_txps)
            if prefetch is not None:
                got = prefetch.finish(
                    cache_key, np.asarray(weights, dtype=np.float64), dtype,
                    device)
                if got is not None:
                    log.info("v4 plan prefetch hit (%s...): route build "
                             "skipped, the entry read during the pack",
                             cache_key[:12])
                    if pointer_key is not None:
                        plan_cache.write_pointer(pointer_key, cache_key)
                    return got
            hit = plan_cache.load(cache_key)
            if hit is not None:
                try:
                    out = plan_cache.finish_from_cache(
                        hit, np.asarray(weights, dtype=np.float64), dtype,
                        device,
                    )
                except (KeyError, ValueError, TypeError) as e:
                    log.warning(
                        "v4 plan cache entry unusable (%s); rebuilding", e
                    )
                else:
                    log.info("v4 plan cache hit (%s...): route build skipped",
                             cache_key[:12])
                    if pointer_key is not None:
                        plan_cache.write_pointer(pointer_key, cache_key)
                    return out
        with trace.span("v4.layout"):
            lay = _v4_layout(txp_id, weights, boundaries, num_txps, pre=pre)
        with trace.span("v4.finish"):
            data = _v4_finish(lay, dtype, device, cache_key=cache_key,
                              pointer_key=pointer_key)
        return data, lay["read_order"]


def _v4_layout(
    txp_id: np.ndarray,
    weights: np.ndarray,
    boundaries: np.ndarray,
    num_txps: int,
    pre: Optional[dict] = None,
    envelope: Optional[dict] = None,
) -> dict:
    """Phase 1 of the v4 build: bucket layouts, slot maps, and the tiny
    T-space tile permutes: everything except the two GlobalRoutes (whose
    geometry a sharded build chooses from all shards' flows, see
    `route_config` and `parallel/sharded_v4.py`).

    Row placement within buckets is flow-balanced (ops/balance.py) when
    the native placer is available: reads and small transcripts are
    greedily assigned to the bucket row whose chunk minimizes the
    running max (txp-chunk, read-chunk) cell load, pulling the route
    quota Q toward the mean flow (random placement leaves it 2-3x
    higher). Rows not chosen stay pads (all-zero slots, inert).

    `pre` (from `V4Prebuild.finish`) replaces the read buckets' size
    classes, the transcript counts and the ranks within transcripts; one
    whose A, R or T differ from this CSR's is ignored.

    `envelope` (`compute_envelope` / `merge_envelopes`) forces the read
    and small-transcript buckets, the big-transcript slots and rows and
    the tile rows of T space: the shards of a sharded build then share
    them. Rows the envelope adds are dead (all-zero slots), and the
    mean-flow rule that skips the balance passes is not applied (as in
    the JAX package).

    Each step ends with a lap of the caller's span (`utils/trace.py`)."""
    txp_id = np.asarray(txp_id, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float64)
    boundaries = np.asarray(boundaries, dtype=np.int64)
    R = len(boundaries) - 1
    A = len(txp_id)
    T = int(num_txps)
    sizes = np.diff(boundaries)

    if pre is not None and (
        pre["A"] != A or pre["R"] != R or len(pre["counts"]) != T
    ):
        log.warning(
            "v4 prebuild shape mismatch (A %d/%d, R %d/%d); building "
            "monolithically", pre["A"], A, pre["R"], R,
        )
        pre = None

    use_balance = _balance.available()
    BCH = _balance.BAL_CHR

    # ---- read-side buckets (membership only; rows assigned below)
    rng_r = np.random.default_rng(3)
    if pre is not None:
        read_shapes, read_starts, read_row_parts, n_slots_r = (
            _pow2_buckets_pre(pre["classes"], pre["max_size"], rng_r,
                              envelope["read_buckets"] if envelope else None,
                              align_groups=True)
        )
    else:
        read_shapes, read_starts, read_row_parts, n_slots_r = _pow2_buckets(
            sizes, rng_r,
            envelope["read_buckets"] if envelope else None,
            align_groups=True,
        )
    row_space_r = sum(rp for rp, _ in read_shapes)
    trace.lap("read_buckets")

    # ---- transcript-side buckets (pow2 up to CAPK, then row-chunked)
    counts = (
        pre["counts"] if pre is not None
        else np.bincount(txp_id, minlength=T)
    )
    rng_t = np.random.default_rng(5)
    small_mask = (counts > 0) & (counts <= CAPK)
    small_sizes = np.where(small_mask, counts, 0)
    env_small = envelope["small_buckets"] if envelope else None
    small_shapes, small_starts, small_row_parts, n_small_slots = (
        _pow2_buckets(small_sizes, rng_t, env_small)
        if (small_mask.any() or env_small)
        else ([], [], [], 0)
    )
    row_space_s = sum(rp for rp, _ in small_shapes)
    trace.lap("small_buckets")

    big_txps = np.nonzero(counts > CAPK)[0]
    big_txps = rng_t.permutation(big_txps)
    n_big_real = len(big_txps)
    # the envelope may force more big slots and rows than this dataset
    # has; the extra entries own no rows and no transcript positions
    n_big = max(n_big_real, envelope["n_big"]) if envelope else n_big_real
    big_chunks = (
        np.ceil(counts[big_txps] / CAPK).astype(np.int64)
        if n_big_real
        else np.empty(0, np.int64)
    )
    n_big_rows = int(big_chunks.sum())
    big_rows_pad = _pad128(n_big_rows)
    if envelope:
        big_rows_pad = max(big_rows_pad, envelope["big_rows_pad"])
    big_off_log = np.zeros(n_big + 1, dtype=np.int64)
    np.cumsum(big_chunks, out=big_off_log[1 : n_big_real + 1])
    big_off_log[n_big_real + 1 :] = big_off_log[n_big_real]
    big_row_offsets = big_off_log
    big_row_of_txp = np.zeros(big_rows_pad, dtype=np.int64)
    if n_big_real:
        big_row_of_txp[:n_big_rows] = np.repeat(
            np.arange(n_big_real), big_chunks
        )
    big_start = n_small_slots
    n_slots_t = n_small_slots + big_rows_pad * CAPK
    trace.lap("big_tables")

    # Layout policy: the greedy/repair balance machinery exists to pull
    # the max route-cell flow under the next 128 quota boundary. When the
    # MEAN cell flow is far below the 128 legality floor, the buckets'
    # within-bucket shuffle alone already lands max flow < 128, so the
    # placement work buys nothing. Skip it when the mean at the usual
    # CR=256 chunking is <= 56 (128 is then >= mean + 6-7 sigma even
    # against the big-region's pinned full rows). A miss costs only a
    # larger Q (slower EM iterations), never correctness.
    if use_balance and envelope is None:
        _chr_est = 256 * LANES
        _n_chk_est = max(
            -(-max(n_slots_r, n_slots_t) // _chr_est), 1
        )
        _mean_flow = A / (_n_chk_est * _n_chk_est)
        if _mean_flow <= 56.0:
            use_balance = False
            log.info(
                "v4 layout: mean cell flow %.1f << Q floor 128; "
                "skipping the balance passes", _mean_flow,
            )

    # per-alignment rank within its transcript (native counting sort;
    # the NumPy form costs an A-sized stable argsort + 4 more passes).
    # With a prebuild the ranks arrived during the pack and ord2 is one
    # scatter (the rank is the stable position)
    _rk = None if pre is not None else _balance.rank_by_key(txp_id, T)
    if pre is not None:
        rank = pre["rank"]
        run_start = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(counts, out=run_start[1:])
        ord2 = np.empty(A, dtype=np.int64)
        ord2[run_start[txp_id] + rank] = np.arange(A, dtype=np.int64)
    elif _rk is not None:
        ord2, rank, run_start = _rk
    else:
        ord2 = np.argsort(txp_id, kind="stable")
        run_start = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(counts, out=run_start[1:])
        rank_sorted = np.arange(A) - run_start[txp_id[ord2]]
        rank = np.zeros(A, dtype=np.int64)
        rank[ord2] = rank_sorted
    trace.lap("rank")

    # ---- big-transcript slots (fixed contiguous rows; their alignment
    # slots smear across many chunks per group, self-decorrelating)
    txp_slot_of_aln = np.zeros(A, dtype=np.int64)
    small_aln = small_mask[txp_id]
    big_aln = counts[txp_id] > CAPK
    # big-alignment index, computed once: boolean-mask gathers over the
    # A-sized arrays were ~45% of this function's own time at A=6M
    big_idx = np.nonzero(big_aln)[0] if n_big_real else None
    if n_big_real:
        big_index = np.full(T, -1, dtype=np.int64)
        big_index[big_txps] = np.arange(n_big_real)
        if not _balance.big_slots(
            txp_id, rank, big_index, big_off_log, CAPK, big_start,
            1, 1, txp_slot_of_aln,
        ):
            bi = big_index[txp_id[big_idx]]
            rk_big = rank[big_idx]
            row = big_off_log[bi] + rk_big // CAPK
            txp_slot_of_aln[big_idx] = _colmajor_slot(
                big_start, CAPK, row, rk_big % CAPK
            )
    trace.lap("big_slots")

    BCHn = ((max(n_slots_r, n_slots_t) + BCH - 1) // BCH) * BCH
    n_chk = BCHn // BCH

    # ---- small-transcript placement (pass 1: per-chunk load balance)
    items_t = (
        np.concatenate(small_row_parts)
        if small_row_parts
        else np.empty(0, np.int64)
    )
    sizes_t = counts[items_t]
    ib_t = (
        np.concatenate(
            [
                np.full(len(rows), bi, dtype=np.int64)
                for bi, rows in enumerate(small_row_parts)
            ]
        )
        if small_row_parts
        else np.empty(0, np.int64)
    )
    buckets_t = [
        (start, K, rows_pad // LANES)
        for (rows_pad, K), start in zip(small_shapes, small_starts)
    ]
    off_t = np.zeros(len(items_t) + 1, dtype=np.int64)
    np.cumsum(sizes_t, out=off_t[1:])
    def _gdiv(arr, idx, div):
        """out = (arr[idx] // div).astype(i32) fused natively (the
        repair loop recomputes these A-sized keys repeatedly)."""
        out = _balance.gather_div_i32(arr, idx, div)
        if out is None:
            g = arr[idx] if idx is not None else arr
            out = (g // div).astype(np.int32)
        return out

    def _desc_order(sz, rng):
        """Descending-size placement order with randomized ties: shuffle,
        then stable-sort by size. The native counting sort replaces the
        R-sized argsort (sizes are small ints); stability makes the two
        forms bit-identical."""
        p = rng.permutation(len(sz))
        s = sz[p]
        mx = int(s.max()) if len(s) else 0
        rk = _balance.rank_by_key(mx - s, mx + 1)
        if rk is not None:
            return p[rk[0]]
        return p[np.argsort(-s, kind="stable")]

    rng_b = np.random.default_rng(7)
    if use_balance and len(items_t):
        order_t = _desc_order(sizes_t, rng_b)
        F1 = np.zeros((1, n_chk), dtype=np.int32)
        if n_big_real:
            F1[0] = np.bincount(
                txp_slot_of_aln[big_idx] // BCH, minlength=n_chk
            )[:n_chk]
        row_within_t, _, _ = _balance.greedy_place(
            off_t, np.zeros(int(off_t[-1]), np.int32), ib_t, buckets_t,
            n_chk, 1, order_t, F1,
        )
    else:
        order_t = None
        row_within_t = (
            np.concatenate(
                [np.arange(len(rows)) for rows in small_row_parts]
            )
            if small_row_parts
            else np.empty(0, np.int64)
        )

    sb_flat_base = np.concatenate(
        [[0], np.cumsum([rp for rp, _ in small_shapes])]
    ).astype(np.int64)

    # per-transcript bucket tables and the small-alignment subset are
    # fixed across repair rounds — hoisted out of _apply_small
    _bK_t = np.zeros(T, dtype=np.int64)
    _bst_t = np.zeros(T, dtype=np.int64)
    for (rows_pad, K), start, rows in zip(
        small_shapes, small_starts, small_row_parts
    ):
        _bK_t[rows] = K
        _bst_t[rows] = start
    small_idx = np.nonzero(small_aln)[0]
    tid_small = txp_id[small_idx]
    rank_small = rank[small_idx]

    def _apply_small(row_within):
        """Small-transcript slot tables from per-item bucket rows; also
        (re)writes the small part of txp_slot_of_aln."""
        row_of = np.full(T, -1, dtype=np.int64)
        pos = np.full(T, -1, dtype=np.int64)
        if len(items_t):
            row_of[items_t] = row_within
            pos[items_t] = sb_flat_base[ib_t] + row_within
        if len(small_idx) and not _balance.small_slots(
            tid_small, rank_small, small_idx, _bst_t, _bK_t,
            row_of, txp_slot_of_aln,
        ):
            t = tid_small
            txp_slot_of_aln[small_idx] = _colmajor_slot(
                _bst_t[t], _bK_t[t], row_of[t], rank_small
            )
        return row_of, pos

    row_of_small_txp, small_txp_row_pos = _apply_small(row_within_t)
    trace.lap("small_pass1")

    # ---- read placement (pass 2: greedy on (txp-chunk, read-chunk)
    # cells — the flow matrix both routes share)
    items_r = (
        np.concatenate(read_row_parts)
        if read_row_parts
        else np.empty(0, np.int64)
    )
    sizes_r = sizes[items_r]
    ib_r = (
        np.concatenate(
            [
                np.full(len(rows), bi, dtype=np.int64)
                for bi, rows in enumerate(read_row_parts)
            ]
        )
        if read_row_parts
        else np.empty(0, np.int64)
    )
    buckets_r = [
        (start, K, rows_pad // LANES)
        for (rows_pad, K), start in zip(read_shapes, read_starts)
    ]
    off_r = np.zeros(len(items_r) + 1, dtype=np.int64)
    np.cumsum(sizes_r, out=off_r[1:])
    tot_r = int(off_r[-1])
    trace.lap("rp2.setup")
    aln_idx_r = _balance.ramp_fill(off_r, boundaries[items_r], tot_r)
    if aln_idx_r is None:
        col_r = np.arange(tot_r) - np.repeat(off_r[:-1], sizes_r)
        aln_idx_r = np.repeat(boundaries[items_r], sizes_r) + col_r
    else:
        # only the NumPy _apply_reads fallback needs col_r, and native
        # ramp_fill implies the native read_slots path is available
        col_r = None
    trace.lap("rp2.ramp")
    if use_balance and len(items_r):
        order_r = _desc_order(sizes_r, rng_b)
        trace.lap("rp2.order")
        row_within_r, _, _ = _balance.greedy_place(
            off_r,
            _gdiv(txp_slot_of_aln, aln_idx_r, BCH),
            ib_r, buckets_r, n_chk, n_chk, order_r,
        )
        trace.lap("rp2.greedy")
    else:
        row_within_r = (
            np.concatenate(
                [np.arange(len(rows)) for rows in read_row_parts]
            )
            if read_row_parts
            else np.empty(0, np.int64)
        )

    rb_flat_base = np.concatenate(
        [[0], np.cumsum([rp for rp, _ in read_shapes])]
    ).astype(np.int64)
    # read id per PADDED row position (unassigned rows get read 0:
    # their slots are all-zero so any multiplicity routed there is inert)
    read_order = np.zeros(row_space_r, dtype=np.int64)
    slot_of_aln = np.zeros(A, dtype=np.int64)

    Kv_r = np.asarray([K for _, K in read_shapes], dtype=np.int64)
    stv_r = np.asarray(read_starts, dtype=np.int64)
    aln_base_r = boundaries[items_r] if len(items_r) else items_r

    def _apply_reads(row_within):
        if len(items_r):
            read_order[:] = 0
            read_order[rb_flat_base[ib_r] + row_within] = items_r
            if not _balance.read_slots(
                off_r, aln_base_r, ib_r, stv_r, Kv_r, row_within,
                slot_of_aln,
            ):
                slot_of_aln[aln_idx_r] = _colmajor_slot(
                    np.repeat(stv_r[ib_r], sizes_r),
                    np.repeat(Kv_r[ib_r], sizes_r),
                    np.repeat(row_within, sizes_r),
                    col_r,
                )

    _apply_reads(row_within_r)
    trace.lap("read_pass2")

    # ---- pass 3: re-place small transcripts against the chosen read
    # layout (transposed flow matrix, big flows preloaded)
    if use_balance and len(items_t):
        idx_t = _balance.ramp_fill(
            off_t, run_start[items_t], int(off_t[-1])
        )
        if idx_t is None:
            col_t = np.arange(int(off_t[-1])) - np.repeat(
                off_t[:-1], sizes_t
            )
            idx_t = np.repeat(run_start[items_t], sizes_t) + col_t
        src3 = _gdiv(slot_of_aln, ord2[idx_t], BCH)
        F3 = None
        if n_big_real:
            F3 = _balance.flows2d(
                slot_of_aln, txp_slot_of_aln, BCH, n_chk, n_chk,
                idx=big_idx,
            )
        if F3 is None:
            F3 = np.zeros((n_chk, n_chk), dtype=np.int32)
            if n_big_real:
                np.add.at(
                    F3,
                    (slot_of_aln[big_idx] // BCH,
                     txp_slot_of_aln[big_idx] // BCH),
                    1,
                )
        row_within_t, _, _ = _balance.greedy_place(
            off_t, src3, ib_t, buckets_t, n_chk, n_chk, order_t, F3,
        )
        row_of_small_txp, small_txp_row_pos = _apply_small(row_within_t)
    trace.lap("small_pass3")

    NPAD = ((max(n_slots_r, n_slots_t) + CH - 1) // CH) * CH

    # ---- pass 4: targeted repair at the SELECTED route granularity.
    # The greedy passes balance at the finest grain; the quota, though,
    # is rounded up to the next legal step (128 with the strided
    # exchange), so only crossing a boundary pays. Re-place items
    # touching over-target cells (exhaustive class scan) at the chosen
    # CR, walking the target down 128 at a time while it sticks.
    route_sel = None
    if use_balance and len(items_r):
        CRsel, npad_sel, _geo_sel = route_config(
            _route_maxflows(slot_of_aln, txp_slot_of_aln, NPAD), NPAD
        )
        CHR_sel = CRsel * LANES
        nT = nR = npad_sel // CHR_sel
        idx_t2 = _balance.ramp_fill(
            off_t, run_start[items_t], int(off_t[-1])
        )
        if idx_t2 is None:
            idx_t2 = np.repeat(run_start[items_t], sizes_t) + (
                np.arange(int(off_t[-1]))
                - np.repeat(off_t[:-1], sizes_t)
            )
        aln_t = ord2[idx_t2]  # alignment ids in txp-item CSR order
        _rlog = log

        def _flows():
            """[read chunk, txp chunk] loads of the full layout."""
            Fx = _balance.flows2d(
                slot_of_aln, txp_slot_of_aln, CHR_sel, nR, nT
            )
            if Fx is None:
                Fx = np.zeros((nR, nT), dtype=np.int32)
                np.add.at(
                    Fx,
                    (slot_of_aln // CHR_sel,
                     txp_slot_of_aln // CHR_sel),
                    1,
                )
            return Fx

        def _big_F():
            """[read chunk, txp chunk] loads of the FIXED big-txp rows."""
            if n_big_real:
                Fb = _balance.flows2d(
                    slot_of_aln, txp_slot_of_aln, CHR_sel, nR, nT,
                    idx=big_idx,
                )
                if Fb is not None:
                    return Fb
            Fb = np.zeros((nR, nT), dtype=np.int32)
            if n_big_real:
                np.add.at(
                    Fb,
                    (slot_of_aln[big_aln] // CHR_sel,
                     txp_slot_of_aln[big_aln] // CHR_sel),
                    1,
                )
            return Fb

        mf = int(_flows().max())
        _rlog.debug("repair: CR=%d nT=%d nR=%d maxflow=%d mean=%.0f",
                    CRsel, nT, nR, mf, A / (nT * nR))

        # only a crossed 128 boundary changes the rounded quota; local
        # search moves the max by a few units per round, so bail when
        # the gap is beyond striking distance (saves ~2/3 of the layout
        # build at the 6M-alignment bench shape, where mf=188 vs 128)
        gap = mf - ((mf - 1) // LANES) * LANES
        skip_repair = gap > 40
        if skip_repair:
            _rlog.debug("repair: gap %d to the next boundary, skipping",
                        gap)
        # re-run the greedy at the SELECTED granularity (the 16K-grain
        # passes above optimize finer cells; the quota is the max over
        # the CHOSEN CR's cells), then local-search repair toward each
        # successive 128 boundary
        if not skip_repair:
            rw_t, rw_r = row_within_t, row_within_r
            row_r2, _, _ = _balance.greedy_place(
                off_r,
                _gdiv(txp_slot_of_aln, aln_idx_r, CHR_sel),
                ib_r, buckets_r, nR, nT, order_r,
                np.ascontiguousarray(_big_F().T), chunk=CHR_sel,
            )
            row_within_r = row_r2
            _apply_reads(row_within_r)
            if len(items_t):
                F3s = _big_F()
                src_t = _gdiv(slot_of_aln, aln_t, CHR_sel)
                row_t2, mx_t, _ = _balance.greedy_place(
                    off_t, src_t, ib_t, buckets_t, nT, nR, order_t,
                    F3s, chunk=CHR_sel,
                )
                row_within_t = row_t2
                row_of_small_txp, small_txp_row_pos = _apply_small(
                    row_within_t
                )
            mf2 = int(_flows().max())
            _rlog.debug("repair: re-greedy at CR -> maxflow=%d", mf2)
            if mf2 > mf:
                # coarse-grain re-placement lost: restore the 16K placement
                row_within_t, row_within_r = rw_t, rw_r
                row_of_small_txp, small_txp_row_pos = _apply_small(
                    row_within_t
                )
                _apply_reads(row_within_r)
                mf2 = mf
            mf = mf2
            target = ((mf - 1) // LANES) * LANES
            while target >= LANES:
                Ff = _flows()
                row_t2, mx_t, Ff = _balance.repair_place(
                    off_t, _gdiv(slot_of_aln, aln_t, CHR_sel),
                    ib_t, buckets_t, nT, nR, row_within_t, Ff,
                    target, CHR_sel, max_rounds=8,
                )
                row_within_t = row_t2
                row_of_small_txp, small_txp_row_pos = _apply_small(
                    row_within_t
                )
                if mx_t > target:
                    F2 = np.ascontiguousarray(Ff.T)
                    row_r2, mx_r, _ = _balance.repair_place(
                        off_r,
                        _gdiv(txp_slot_of_aln, aln_idx_r, CHR_sel),
                        ib_r, buckets_r, nR, nT, row_within_r, F2,
                        target, CHR_sel, max_rounds=8,
                    )
                    row_within_r = row_r2
                    _apply_reads(row_within_r)
                    mf = mx_r
                else:
                    mf = mx_t
                _rlog.debug("repair: target=%d -> txp=%d read-side=%d",
                            target, mx_t, mf)
                if mf > target:
                    break
                target -= LANES
        # the repair optimized the placement FOR this chunk size; pin
        # (CR, final maxflow) so _v4_finish skips its 3-way route_maxflow
        # recompute over all CR candidates
        route_sel = (CRsel, int(mf))
    trace.lap("repair_pass4")

    # ---- tiny T-space tile permutes
    t_rows = _tile_rows(max(T, row_space_s + n_big, 1))
    if envelope:
        t_rows = max(t_rows, envelope["t_rows"])
    t_space = t_rows * LANES
    # t_in: out[row pos] = prev[small txp of that row], then the big
    # txps as a dense block after the small row space
    have_s = small_txp_row_pos >= 0
    perm_in = np.full(t_space, -1, dtype=np.int64)
    perm_in[small_txp_row_pos[have_s]] = np.nonzero(have_s)[0]
    if n_big_real:
        perm_in[row_space_s : row_space_s + n_big_real] = big_txps
    used = np.zeros(t_space, dtype=bool)
    used[perm_in[perm_in >= 0]] = True
    free_out = np.nonzero(perm_in < 0)[0]
    perm_in[free_out] = np.nonzero(~used)[0]

    # t_out: curr[t] = v[pos_of_t]; v = [small row sums (flat row
    # positions), big txp sums, zeros]; empty transcripts route from
    # the zero tail (padded rows sum to zero as well)
    pos_of_txp = np.full(T, -1, dtype=np.int64)
    pos_of_txp[have_s] = small_txp_row_pos[have_s]
    if n_big_real:
        pos_of_txp[big_txps] = row_space_s + np.arange(n_big_real)
    perm_out = np.full(t_space, -1, dtype=np.int64)
    have = pos_of_txp >= 0
    perm_out[np.nonzero(have)[0]] = pos_of_txp[have]
    free_out = np.nonzero(perm_out < 0)[0]
    used = np.zeros(t_space, dtype=bool)
    used[pos_of_txp[have]] = True
    # route empty/pad outputs from slots past the live v prefix where
    # possible (they hold zeros); any leftover free inputs also work
    # because v's tail is zero-filled
    perm_out[free_out] = np.nonzero(~used)[0]
    trace.lap("tile_permute_specs")

    return {
        "slot_of_aln": slot_of_aln,
        "txp_slot_of_aln": txp_slot_of_aln,
        "weights": weights,
        "NPAD": NPAD,
        "read_order": read_order,
        # the tile-permute specs (~2 MB): `_device_parts` colors them
        # into t_in/t_out, and the plan cache stores them as they are
        "t_perm_in": perm_in,
        "t_perm_out": perm_out,
        "t_rows": t_rows,
        "big_row_of_txp": big_row_of_txp,
        "big_row_offsets": big_row_offsets,
        "read_shapes": tuple(read_shapes),
        "read_starts": tuple(read_starts),
        "n_slots_r": n_slots_r,
        "row_space_r": row_space_r,
        "small_shapes": tuple(small_shapes),
        "small_starts": tuple(small_starts),
        "row_space_s": row_space_s,
        "big_rows_pad": big_rows_pad,
        "n_big": n_big,
        "n_slots_t": n_slots_t,
        "t_space": t_space,
        "num_reads": R,
        "num_txps": T,
        "route_sel": route_sel,
    }


_CR_CANDIDATES = (128, 256, 512)  # route chunk sizes (128-lane rows)


def _route_maxflows(slot_of_aln, txp_slot_of_aln, NPAD: int) -> dict:
    """{chunk_rows: max per-(src,dst)-chunk flow} over the candidates."""
    mfs = {}
    for CR in _CR_CANDIDATES:
        CHR = CR * LANES
        npad_r = ((NPAD + CHR - 1) // CHR) * CHR
        mfs[CR] = route_maxflow(slot_of_aln, txp_slot_of_aln, npad_r,
                                chunk=CHR)
    return mfs


def route_config(mfs: dict, NPAD: int) -> Tuple[int, int, Tuple]:
    """Pick (chunk_rows, npad_rounded, (npd, Q)) from a {chunk_rows:
    maxflow} dict, minimizing the JAX package's estimate of the per-route
    cost: three passes over the quota tensor plus the gather-network work
    (H_in x H_out block gathers per chunk). Larger chunks concentrate the
    per-pair flows toward their mean (less quota inflation) but cost more
    shuffle work. The rule is kept as it is so that both packages choose
    the same plan."""
    best = None
    for CR, mf in mfs.items():
        CHR = CR * LANES
        npad_r = ((NPAD + CHR - 1) // CHR) * CHR
        npd, Q = select_route_geometry(npad_r // CHR, mf)
        R1 = npd * Q // LANES
        if R1 % LANES or R1 // LANES > 16:
            continue
        area = npd * npd * Q  # quota elements
        shuffle = npd * (CR // LANES) * (R1 // LANES) * (LANES * LANES)
        cost = 3 * area + shuffle
        if best is None or cost < best[0]:
            best = (cost, CR, npad_r, (npd, Q))
    if best is None:
        raise ValueError("no feasible route geometry at any chunk size")
    CR, npad_r, (npd, Q) = best[1], best[2], best[3]
    # Transpose-free upgrade: round Q to whole lane tiles so the quota
    # exchange needs no transpose (the reduce side reads its column slab
    # of the src-major quota tensor); adopted while the quota area grows
    # by at most 35%, the JAX package's break-even.
    if Q % LANES != 0:
        npd128, Q128 = select_route_geometry(
            npad_r // (CR * LANES), mfs[CR], q128=True
        )
        R1 = npd128 * Q128 // LANES
        ok = R1 % LANES == 0 and R1 // LANES <= 16
        if ok and npd128 * Q128 <= 1.35 * npd * Q:
            npd, Q = npd128, Q128
    return CR, npad_r, (npd, Q)


def _read_lvl_ids(read_shapes, read_starts, n_chunks: int,
                  CR: int) -> Optional[np.ndarray]:
    """[n_chunks * CR, 128] i8: per route-chunk kernel row, log2(K) of
    the read bucket owning it, broadcast across lanes (-1 for rows
    outside any read bucket — alignment gaps, the transcript-layout
    region, and the rounding tail). Group-aligned bucket starts
    guarantee no K-row group straddles a chunk, so the fused middle
    kernel's pairwise-sum pyramid covers every read. Returns None
    (fused middle disabled) when some bucket is wider than a chunk."""
    CHR = CR * LANES
    if any(K > CR for _rp, K in read_shapes):
        return None
    lvl = np.full(n_chunks * CR, -1, dtype=np.int8)
    for (rows_pad, K), start in zip(read_shapes, read_starts):
        s = int(K).bit_length() - 1
        assert (1 << s) == K, "bucket widths must be powers of two"
        for g in range(rows_pad // LANES):
            base = start + g * K * LANES
            r0 = base // LANES
            assert (base % CHR) // LANES + K <= CR, (
                "read group straddles a route chunk"
            )
            lvl[r0 : r0 + K] = s
    return np.broadcast_to(
        lvl[:, None], (n_chunks * CR, LANES)
    ).copy()


def _v4_finish(lay: dict, dtype: torch.dtype, device: torch.device,
               cache_key: Optional[str] = None,
               pointer_key: Optional[str] = None,
               geometry: Optional[Tuple] = None) -> EmV4Data:
    """Phase 2: construct the two GlobalRoutes and assemble the device
    state. The routes over the unified rounded space are partial
    injective maps: uncovered outputs (the bucket pads) come out ZERO,
    which is exactly the invariant both row-sum stages need. With
    `cache_key` the host-side products are persisted to the plan cache on
    a background thread, and the BAM pointer `pointer_key` after it.
    `geometry` forces the (chunk_rows, npad, (npd, Q)) of `route_config`,
    as a sharded build does with the one its shards share."""
    if geometry is not None:
        CR, NPAD, geo = geometry
    else:
        sel = lay.get("route_sel")
        mfs = ({sel[0]: sel[1]} if sel is not None else _route_maxflows(
            lay["slot_of_aln"], lay["txp_slot_of_aln"], lay["NPAD"]))
        CR, NPAD, geo = route_config(mfs, lay["NPAD"])
    routes = build_route_pair_async(
        lay["slot_of_aln"], lay["txp_slot_of_aln"], NPAD,
        force_geometry=geo, chunk_rows=CR,
        keep_host=cache_key is not None, device=device,
    )
    # geometry is known immediately; build + ship everything that only
    # depends on it WHILE the native coloring/table fill runs on its
    # worker thread (it releases the GIL)
    seg_id = _read_lvl_ids(
        lay["read_shapes"], lay["read_starts"], routes.n_dst, CR
    )
    w_txp = _w_txp(lay["txp_slot_of_aln"], lay["weights"],
                   routes.n_src * CR * LANES)
    parts = _device_parts(lay, seg_id, w_txp, dtype, device)
    trace.lap("seg_id_w_txp_tiles")
    p_a, p_b = routes()
    trace.lap("routes_join_upload")
    if cache_key is not None:
        plan_cache.store_async(
            cache_key, plan_cache.payload_from_build(lay, routes.host, seg_id),
            pointer_key=pointer_key,
        )
    return assemble(lay, p_a, p_b, parts)


def _w_txp(txp_slot_of_aln: np.ndarray, weights: np.ndarray,
           n: int) -> np.ndarray:
    """Weights in the transcript-bucket layout, at the route's padded
    length so the expand kernel takes them without a pad copy."""
    w_txp = np.zeros(n, dtype=np.float64)
    w_txp[txp_slot_of_aln] = weights
    return w_txp


def _device_parts(lay: dict, seg_id: Optional[np.ndarray], w_txp: np.ndarray,
                  dtype: torch.dtype, device: torch.device) -> dict:
    """Everything of the device state but the two routes, from the
    layout's tile-permute specs and big-transcript tables."""
    def tile(perm):
        plan = DeviceTilePlan.build(perm, lay["t_rows"])
        return BatchTilePermute.build([plan], device=device)

    def dev(a, to=None):
        t = torch.as_tensor(np.ascontiguousarray(a), device=device)
        return t if to is None else t.to(to)

    return {
        "w_txp": dev(w_txp, dtype),
        "t_in": tile(lay["t_perm_in"]),
        "t_out": tile(lay["t_perm_out"]),
        "big_row_of_txp": dev(lay["big_row_of_txp"], torch.int64),
        "big_row_offsets": dev(lay["big_row_offsets"], torch.int64),
        "seg_id": None if seg_id is None else dev(seg_id),
    }


def txp_buckets(small_shapes, small_starts, big_rows_pad: int,
                n_slots_t: int):
    """(shapes, starts) of the transcript layout: the small buckets, then
    the big-transcript region as one more bucket of CAPK-wide rows."""
    if not big_rows_pad:
        return tuple(small_shapes), tuple(small_starts)
    return ((*small_shapes, (big_rows_pad, CAPK)),
            (*small_starts, n_slots_t - big_rows_pad * CAPK))


def row_sources(meta, p_a: GlobalRoutePlan, device) -> dict:
    """`t_row_src` / `r_row_src` of `EmV4Data` from the layout's static
    metadata (a mapping with the fields of that name) and the route's
    geometry."""
    def dev(a):
        return torch.as_tensor(a, device=device)

    CR = p_a.chunk_rows
    return {
        "t_row_src": dev(_row_sources(
            *txp_buckets(meta["small_shapes"], meta["small_starts"],
                         meta["big_rows_pad"], meta["n_slots_t"]),
            p_a.n_src * CR)),
        "r_row_src": dev(_row_sources(
            meta["read_shapes"], meta["read_starts"], p_a.n_dst * CR)),
    }


def assemble(lay: dict, p_a: GlobalRoutePlan, p_b: GlobalRoutePlan,
             parts: dict) -> EmV4Data:
    return EmV4Data(
        p_a=p_a,
        p_b=p_b,
        **parts,
        **row_sources(lay, p_a, p_a.device),
        **{k: lay[k] for k in (
            "read_shapes", "read_starts", "n_slots_r", "row_space_r",
            "small_shapes", "small_starts", "row_space_s", "big_rows_pad",
            "n_big", "n_slots_t", "t_space", "num_reads", "num_txps")},
    )


def _row_sources(shapes, starts, total_rows: int) -> np.ndarray:
    """The column-major layout seen as 128-lane rows: group g of a bucket
    (128 bucket rows) fills K consecutive 128-lane rows with its 128 values.
    Returns, per 128-lane row of a slot space of `total_rows` rows, the
    index of the group that fills it, counted over the buckets in order;
    rows outside every bucket (alignment gaps, the tail) name one group
    past the last, which `_row_broadcast` keeps at zero."""
    src = np.full(total_rows, sum(rp for rp, _ in shapes) // LANES,
                  dtype=np.int64)
    g0 = 0
    for (rows_pad, K), start in zip(shapes, starts):
        g, r0 = rows_pad // LANES, start // LANES
        src[r0 : r0 + g * K] = g0 + np.repeat(np.arange(g), K)
        g0 += g
    return src


def _row_broadcast(values: Sequence[torch.Tensor],
                   row_src: torch.Tensor) -> torch.Tensor:
    """Inverse of the bucket row sums: expand one value per bucket row
    (`values`, concatenated along the last axis) across its K slots,
    zeros outside the buckets. One gather of 128-lane rows by the layout's
    static `_row_sources`; leading axes (replicates) are kept."""
    lead = values[0].shape[:-1]
    table = torch.cat([*values, values[0].new_zeros((*lead, LANES))], dim=-1)
    table = table.view(*lead, -1, LANES)
    return table.index_select(-2, row_src).reshape(*lead, -1)


def _prev_slots(data: EmV4Data, prev: torch.Tensor) -> torch.Tensor:
    """Front glue: prev padded to t_space (`[t_space]` or `[B, t_space]`)
    -> prev in the transcript slot layout, zero-tailed to the route pad
    (steps 1-2 of the m-step); the * w_txp product is fused into the
    expand kernel of p_a."""
    # deliver prev to transcript rows (tiny static tile permute)
    pr = data.t_in(prev)
    values = [pr[..., : data.row_space_s]]
    if data.big_rows_pad:
        pr_big = pr[..., data.row_space_s : data.row_space_s + data.n_big]
        values.append(pr_big.index_select(-1, data.big_row_of_txp))
    return _row_broadcast(values, data.t_row_src)


def _txp_tail(data: EmV4Data, inc_t: torch.Tensor) -> torch.Tensor:
    """Back glue: transcript-layout increments (`[n]` or `[B, n]`) -> curr
    in t_space: row sums, big-transcript second level and the zero pad
    (pad positions route only zeros and stay zero every iteration) in one
    launch, then the output tile permute."""
    return data.t_out(row_sums(inc_t, data.tail_plan))


def mult_slots(data: EmV4Data, multiplicity: torch.Tensor) -> torch.Tensor:
    """Per-row multiplicities (`[row_space_r]`, or `[B, row_space_r]` for B
    replicates, in `read_order`) broadcast to the read slot layout
    `[n_dst*CR, 128]` (`[B, n_dst*CR, 128]`) the fused middle takes. Static
    over a run: made once, outside the loop."""
    slots = _row_broadcast([multiplicity], data.r_row_src)
    return slots.view(*multiplicity.shape[:-1], -1, LANES)


def _middle_fused(data: EmV4Data, prev_slots: torch.Tensor,
                  mult_sl: Optional[torch.Tensor],
                  strided: Optional[bool] = None) -> torch.Tensor:
    """Steps 3+4 through the fused middle kernel: route A's reduce stage,
    the denominators, the guarded reciprocal scaling and route B's expand
    stage per read chunk; contrib never leaves the kernel. `strided`
    names the exchange; None takes the strided one where it applies."""
    pa, pb = data.p_a, data.p_b
    # transpose-free exchanges when the quota is whole lane tiles: stage 1
    # emits the src-major quota tensor and both consumers read their
    # dst-chunk column slab out of it
    if strided is None:
        strided = pa.Q % LANES == 0
    if strided:
        zg = pa.quota_view(pa.expand_y1(prev_slots, mul=data.w_txp))
    else:
        zg = pa.expand(prev_slots, mul=data.w_txp)
    y1b = _route_middle(data, zg, mult_sl)
    if strided:
        return pb.reduce_strided(y1b, sliced=False)
    zgb = y1b.reshape(pb.n_src, pb.n_dst, pb.Q).transpose(0, 1).contiguous()
    return pb.reduce(zgb.reshape(pb.n_dst * pb.R3, LANES), sliced=False)


def _route_middle(data: EmV4Data, zg: torch.Tensor,
                  mult_sl: Optional[torch.Tensor]) -> torch.Tensor:
    """The fused middle kernel on this layout's stages: route A's reduce
    stage, route B's expand stage."""
    return route_middle(
        zg, data.seg_id, data.p_a.reduce_stage, data.p_b.expand_stage,
        thresh=float(EM_DENOM_THRESH), max_lvl=data.max_lvl, mult=mult_sl,
    )


def _middle_unfused(data: EmV4Data, prev_slots: torch.Tensor,
                    multiplicity: Optional[torch.Tensor]) -> torch.Tensor:
    """Steps 3+4 with the read layout materialized between the two routes:
    the path of a layout with a read bucket wider than a route chunk
    (`seg_id is None`)."""
    contrib_r = data.p_a(prev_slots, mul=data.w_txp, sliced=False)
    denom = row_sums(contrib_r, data.read_sum_table)
    scale = torch.where(denom > EM_DENOM_THRESH, 1.0 / denom, 0.0)
    if multiplicity is not None:
        scale = scale * multiplicity
    scale_slots = _row_broadcast([scale], data.r_row_src)
    return data.p_b(contrib_r, mul=scale_slots, sliced=False)


def _m_step_v4(data: EmV4Data, prev: torch.Tensor,
               multiplicity: Optional[torch.Tensor] = None,
               mult_sl: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One routed E/M step in the t_space-padded space: `prev`
    `[t_space]` -> `[t_space]`. `multiplicity` is `[row_space_r]` in
    `read_order`; the fused path takes it as `mult_sl` (`mult_slots`),
    made here when the caller has not."""
    prev_slots = _prev_slots(data, prev)
    if data.seg_id is not None:
        if multiplicity is not None and mult_sl is None:
            mult_sl = mult_slots(data, multiplicity)
        inc_t = _middle_fused(data, prev_slots, mult_sl)
    else:
        inc_t = _middle_unfused(data, prev_slots, multiplicity)
    return _txp_tail(data, inc_t)


def _batch_eligible(data: EmV4Data) -> bool:
    """Whether a batch of replicates can be one launch a stage: the
    replicate arms cover the default path, the fused middle with the
    strided exchange."""
    return data.seg_id is not None and data.p_a.Q % LANES == 0


def _m_step_v4_batch(data: EmV4Data, prev_b: torch.Tensor,
                     mult_b: Optional[torch.Tensor] = None,
                     mult_sl_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The m-step of B replicates as one program: `prev_b` `[B, t_space]`
    -> `[B, t_space]`, with one launch of the expand stage, the fused
    middle and the reduce stage (and of each tile permute) for all
    replicates, the routing tables and the level table read once a launch.
    `mult_b` is `[B, row_space_r]` in `read_order`, or already in the slot
    layout as `mult_sl_b` (`mult_slots`). Every replicate comes out as
    `_m_step_v4` gives it."""
    pa, pb = data.p_a, data.p_b
    if mult_b is not None and mult_sl_b is None:
        mult_sl_b = mult_slots(data, mult_b)
    y1 = pa.expand_y1_batch(_prev_slots(data, prev_b), mul=data.w_txp)
    y1b = _route_middle(data, pa.quota_view(y1), mult_sl_b)
    return _txp_tail(data, pb.reduce_strided_batch(y1b, sliced=False))


_loop_logged = False


def _m_step_v4_b(data: EmV4Data, prev_b: torch.Tensor,
                 mult_b: Optional[torch.Tensor] = None,
                 mult_sl_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The m-step of B replicates: one program where the layout allows it,
    else (unfused middle, transposed exchange) one replicate after
    another, each through its own launches. Multiplicities as in
    `_m_step_v4_batch`."""
    global _loop_logged
    if _batch_eligible(data):
        return _m_step_v4_batch(data, prev_b, mult_b, mult_sl_b)
    if not _loop_logged:
        _loop_logged = True
        log.info("v4 layout without the %s: replicates of a batch run one "
                 "after another",
                 "fused middle" if data.seg_id is None else "strided exchange")

    def of(t, b):
        return None if t is None else t[b]

    return torch.stack([
        _m_step_v4(data, prev_b[b], of(mult_b, b), of(mult_sl_b, b))
        for b in range(prev_b.shape[0])])


def _mult_form(data: EmV4Data, multiplicity: torch.Tensor) -> torch.Tensor:
    """Multiplicities (`[row_space_r]` or `[B, row_space_r]`) as the
    m-step takes them: in the slot layout on the fused path (`mult_slots`),
    else as rows."""
    mult = multiplicity.to(data.w_txp.dtype)
    return mult_slots(data, mult) if data.seg_id is not None else mult


def _step_with(data: EmV4Data, prev: torch.Tensor,
               form: Optional[torch.Tensor]) -> torch.Tensor:
    """The m-step of `prev` (`[t_space]`, or `[B, t_space]` for a batch of
    replicates) with multiplicities in `_mult_form`, or none."""
    step = _m_step_v4 if prev.dim() == 1 else _m_step_v4_b
    if data.seg_id is not None:
        return step(data, prev, None, form)
    return step(data, prev, form, None)


def make_m_step(data: EmV4Data, multiplicity: Optional[torch.Tensor]):
    """The m-step of a run as a function of `prev`: `[t_space]` with
    `multiplicity` `[row_space_r]` or none, or `[B, t_space]` with
    `[B, row_space_r]` or none for a batch of replicates. The fused path's
    slot layout of the multiplicities is made once, here."""
    form = None if multiplicity is None else _mult_form(data, multiplicity)
    return lambda prev: _step_with(data, prev, form)


def _extend(data: EmV4Data, init: torch.Tensor) -> torch.Tensor:
    """`init` (`[..., T]`) padded with zeros to t_space, in the layout's
    dtype."""
    return torch.nn.functional.pad(
        init.to(data.w_txp.dtype), (0, data.t_space - data.num_txps))


def _run(loop, data: EmV4Data, init, max_iter, convergence_thresh,
         multiplicity, min_iters):
    """The EM in the t_space-padded space, as the JAX package's
    `make_runner` runs it: `init` is padded with zeros outside the loop and
    the counts are cut back to T after it. Pad positions hold zeros, route
    to zeros, and are masked out of the convergence test (`_rel_diff`
    requires prev > 1e-5)."""
    m_step = make_m_step(data, multiplicity)
    prev, niter = loop(m_step, _extend(data, init), max_iter,
                       convergence_thresh, min_iters)
    return finish_em(m_step, prev)[..., :data.num_txps], niter


def run_em_v4(
    data: EmV4Data,
    init: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    multiplicity: Optional[torch.Tensor] = None,
    min_iters: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same loop semantics as `em.run_em` (`em.rs:144-255`). `init` `[T]`,
    or `[B, T]` with `multiplicity` `[B, row_space_r]` (in `read_order`)
    for B replicates in one program (`_m_step_v4_b`), each frozen at its
    own stopping point: the counterpart of the JAX package's
    `run_em_v4_batch`."""
    return _run(em_loop, data, init, max_iter, convergence_thresh,
                multiplicity, min_iters)


def run_em_v4_squarem(
    data: EmV4Data,
    init: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    multiplicity: Optional[torch.Tensor] = None,
    min_iters: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`run_em_v4` with SQUAREM acceleration (`em.squarem_loop`); with
    `init` `[B, T]` the counterpart of `run_em_v4_batch_squarem`."""
    return _run(squarem_loop, data, init, max_iter, convergence_thresh,
                multiplicity, min_iters)


def replicate_step(data: EmV4Data, max_iter: int, convergence_thresh: float,
                   accel: str = "none") -> BatchStep:
    """The routed EM's `BatchStep`: `_m_step_v4_b` in the t_space-padded
    space, the multiplicities `[n, row_space_r]` in `read_order`."""
    return BatchStep(
        lambda prev, form: _step_with(data, prev, form), max_iter,
        convergence_thresh, accel,
        mult=lambda m: _mult_form(data, m),
        start=lambda init: _extend(data, init))
