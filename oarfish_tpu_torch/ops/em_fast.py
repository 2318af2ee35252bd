"""Scatter-free sparse EM formulation.

Counterpart of the JAX package's `ops/em_fast.py`; same layouts, same
arithmetic, so both packages can be held against each other on identical
tables:

* **Denominators**: reads are bucketed by alignment count into dense
  `[rows, K]` tables (power-of-two K, zero-padded). The per-read denom is
  a row reduction; no segment ops at all. Reads are *relabeled* so bucket
  rows are contiguous, making the per-read scale vector a concatenation
  (no scatter).
* **M-step**: alignments sorted by transcript (CSC). The per-transcript
  sum is an exclusive-cumsum difference at the T+1 transcript offsets:
  a tile-local cumsum plus a double-double prefix over tile totals, so
  f32 mode keeps near-f64 segmented-sum precision (a plain f32 cumsum of
  millions of elements loses whole reads' worth of mass). Nothing here
  uses atomics, so a run is bit-reproducible.
* The only irregular accesses are one gather from the `prev` counts table
  (T-sized) and one gather of per-read scales at CSC positions (R-sized).
  With `use_pallas_gather` (the name is the JAX package's; `--em-impl
  pallas`) the first goes through the hand-written sorted-gather kernel
  (`ops/sorted_gather.py`), otherwise through torch indexing.

Every function takes `prev` as `[T]` or `[B, T]` (bootstrap replicates).
Semantics are identical to `ops/em.py` (`em.rs:144-255` serial path).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..constants import EM_DENOM_THRESH
from ..device import resolve_device
from .em import BatchStep, em_loop, finish_em, squarem_em
from .sorted_gather import SortedGatherPlan, gather_rows

log = logging.getLogger("oarfish_tpu_torch")

TILE = 512


def _two_sum(a, b):
    s = a + b
    bv = s - a
    err = (a - (s - bv)) + (b - bv)
    return s, err


def _dd_add(x, y):
    """Double-double addition for the prefix scan."""
    (xh, xl), (yh, yl) = x, y
    s, e = _two_sum(xh, yh)
    e = e + xl + yl
    hi, lo = _two_sum(s, e)
    return hi, lo


def exclusive_tile_prefix(
    tile_sums: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exclusive prefix of tile totals (last axis) as an unevaluated
    (hi, lo) pair. Returns length n+1 arrays (entry n = total), so an
    offset landing exactly at the padded end still resolves.

    f32 totals are summed by one f64 `cumsum` and split into an f32 pair,
    which carries more bits than an f32 double-double. f64 totals go
    through a Hillis-Steele doubling scan with `_dd_add`. Either way the
    result is the JAX package's `associative_scan` up to the order of
    additions, so EM results agree to tolerance, not to the bit."""
    zero = torch.zeros_like(tile_sums[..., :1])
    if tile_sums.dtype == torch.float32:
        total = torch.cumsum(tile_sums.double(), dim=-1)
        hi = total.float()
        lo = (total - hi.double()).float()
    else:
        hi, lo = tile_sums, torch.zeros_like(tile_sums)
        n = tile_sums.shape[-1]
        shift = 1
        while shift < n:
            sh, sl = _dd_add(
                (hi[..., shift:], lo[..., shift:]),
                (hi[..., :-shift], lo[..., :-shift]),
            )
            hi = torch.cat([hi[..., :shift], sh], dim=-1)
            lo = torch.cat([lo[..., :shift], sl], dim=-1)
            shift *= 2
    return torch.cat([zero, hi], dim=-1), torch.cat([zero, lo], dim=-1)


def offset_tables(txp_offsets: torch.Tensor):
    """(off_tile, off_prev, off_inner) of `FastEmData` for given offsets."""
    return (
        txp_offsets // TILE,
        (txp_offsets - 1).clamp_min(0),
        txp_offsets % TILE != 0,
    )


@dataclass(frozen=True)
class FastEmData:
    """Static device layouts for the scatter-free EM."""

    bucket_txp: Tuple[torch.Tensor, ...]  # each [rows_b, K_b] i32 (T = pad)
    bucket_w: Tuple[torch.Tensor, ...]  # each [rows_b, K_b] f32/f64
    txp_csc: torch.Tensor  # [A_pad] i32 sorted (T = pad)
    w_csc: torch.Tensor  # [A_pad]
    read_csc: torch.Tensor  # [A_pad] i32 relabeled read ids (R = pad)
    txp_offsets: torch.Tensor  # [T+1] i64 offsets into the CSC array
    # derived from txp_offsets once (`offset_tables`): tile of each offset,
    # position of the in-tile cumsum that ends just before it, and whether
    # it has an in-tile part at all (it has none on a tile boundary)
    off_tile: torch.Tensor  # [T+1] i64: offset // TILE
    off_prev: torch.Tensor  # [T+1] i64: max(offset - 1, 0)
    off_inner: torch.Tensor  # [T+1] bool: offset % TILE != 0
    # optional sorted-gather plan arrays (ops/sorted_gather.py)
    g_p0: Optional[torch.Tensor]  # [g_rows] i32 base table row
    g_code: Optional[torch.Tensor]  # [g_rows, 128] u8: lane | use_hi << 7
    bucket_rows: Tuple[int, ...]
    num_reads: int
    num_txps: int
    num_tiles: int
    g_rows: int
    g_table_rows: int
    use_pallas_gather: bool

    @property
    def device(self) -> torch.device:
        return self.w_csc.device

    @staticmethod
    def build(
        txp_id: np.ndarray,
        weights: np.ndarray,
        boundaries: np.ndarray,
        num_txps: int,
        dtype: torch.dtype = torch.float32,
        use_pallas_gather: bool = False,
        device=None,
    ) -> Tuple["FastEmData", np.ndarray]:
        """Returns (data, read_order) where `read_order[i]` is the original
        read index of relabeled read i (multiplicity vectors must be
        provided in relabeled order). `device=None` is the package default
        (`cuda`; raises without a card), `"cpu"` is the host on request.

        With `use_pallas_gather` a layout on the card always carries the
        gather plan, so its m-step always launches the kernel. A layout on
        the CPU, where the plan only feeds the plain version, keeps the JAX
        package's rule and drops a plan of more than `4A + TILE` elements,
        so that both packages build identical tables there."""
        device = resolve_device(device)
        txp_id = np.asarray(txp_id, dtype=np.int64)
        weights = np.asarray(weights, dtype=np.float64)
        boundaries = np.asarray(boundaries, dtype=np.int64)
        R = len(boundaries) - 1
        A = len(txp_id)
        T = int(num_txps)
        sizes = np.diff(boundaries)

        def dev(a, to=None):
            t = torch.as_tensor(np.ascontiguousarray(a), device=device)
            return t if to is None else t.to(to)

        # --- read buckets by padded alignment count
        bucket_txp: List[torch.Tensor] = []
        bucket_w: List[torch.Tensor] = []
        bucket_rows: List[int] = []
        order_parts: List[np.ndarray] = []
        maxk = int(sizes.max()) if R else 1
        K = 1
        ks: List[int] = []
        while K < maxk:
            ks.append(K)
            K *= 2
        ks.append(max(K, 1))
        lo = 0
        for K in ks:
            rows = np.nonzero((sizes > lo) & (sizes <= K))[0]
            lo = K
            if len(rows) == 0:
                continue
            tt = np.full((len(rows), K), T, dtype=np.int32)
            ww = np.zeros((len(rows), K), dtype=np.float64)
            starts = boundaries[rows]
            row_sizes = sizes[rows]
            # ragged fill
            rep = np.repeat(np.arange(len(rows)), row_sizes)
            col = (
                np.arange(int(row_sizes.sum()))
                - np.repeat(
                    np.concatenate([[0], np.cumsum(row_sizes)[:-1]]), row_sizes
                )
            )
            src = np.repeat(starts, row_sizes) + col
            tt[rep, col] = txp_id[src]
            ww[rep, col] = weights[src]
            bucket_txp.append(dev(tt))
            bucket_w.append(dev(ww, dtype))
            bucket_rows.append(len(rows))
            order_parts.append(rows)

        read_order = (
            np.concatenate(order_parts) if order_parts else np.empty(0, np.int64)
        )
        # relabel: original read -> new contiguous id
        new_id = np.empty(R + 1, dtype=np.int64)
        new_id[read_order] = np.arange(R)
        new_id[R] = R  # dummy

        # --- CSC layout, padded to TILE
        order = np.argsort(txp_id, kind="stable")
        read_of_aln = np.repeat(np.arange(R, dtype=np.int64), sizes)
        txp_sorted = txp_id[order]
        w_sorted = weights[order]
        read_sorted = new_id[read_of_aln[order]]

        counts = np.bincount(txp_id, minlength=T)
        offsets = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])

        plan = None
        if use_pallas_gather and A:
            plan = SortedGatherPlan.build(txp_sorted, T + 1, device=device)
            # The row split gives at most A/128 full rows and (T+1)/128 + 1
            # rows cut short by their index span, so the plan never exceeds
            # A + T + 129 elements plus the padding to 256 rows: the kernel's
            # cost stays linear however sparse the index set is. The cut-off
            # below is the JAX package's cost rule for its one-hot delivery.
            if device.type == "cpu" and plan.out_len > 4 * A + TILE:
                log.warning(
                    "sorted-gather plan of %d elements for %d alignments "
                    "exceeds 4A+%d: using torch indexing instead",
                    plan.out_len, A, TILE,
                )
                plan = None
        if plan is not None:
            L = plan.out_len
            mask = plan.src_pos >= 0
            w_csc = np.zeros(L, dtype=np.float64)
            read_csc = np.full(L, R, dtype=np.int32)
            w_csc[mask] = w_sorted[plan.src_pos[mask]]
            read_csc[mask] = read_sorted[plan.src_pos[mask]]
            txp_csc = np.full(L, T, dtype=np.int32)  # unused on device
            # transcript offsets in plan (padded) coordinates
            inv = np.zeros(A + 1, dtype=np.int64)
            inv[plan.src_pos[mask]] = np.nonzero(mask)[0]
            inv[A] = L
            offsets = inv[offsets]
            A_pad = L
        else:
            A_pad = ((A + TILE - 1) // TILE) * TILE if A else TILE
            txp_csc = np.full(A_pad, T, dtype=np.int32)
            w_csc = np.zeros(A_pad, dtype=np.float64)
            read_csc = np.full(A_pad, R, dtype=np.int32)
            txp_csc[:A] = txp_sorted
            w_csc[:A] = w_sorted
            read_csc[:A] = read_sorted

        offsets_t = dev(offsets)
        off_tile, off_prev, off_inner = offset_tables(offsets_t)
        data = FastEmData(
            bucket_txp=tuple(bucket_txp),
            bucket_w=tuple(bucket_w),
            txp_csc=dev(txp_csc),
            w_csc=dev(w_csc, dtype),
            read_csc=dev(read_csc),
            txp_offsets=offsets_t,
            off_tile=off_tile,
            off_prev=off_prev,
            off_inner=off_inner,
            g_p0=plan.base if plan is not None else None,
            g_code=plan.code if plan is not None else None,
            bucket_rows=tuple(bucket_rows),
            num_reads=R,
            num_txps=T,
            num_tiles=A_pad // TILE,
            g_rows=plan.n_rows if plan is not None else 0,
            g_table_rows=plan.table_rows if plan is not None else 0,
            use_pallas_gather=plan is not None,
        )
        return data, read_order


def _m_step_fast(
    data: FastEmData, prev: torch.Tensor,
    multiplicity: Optional[torch.Tensor],
) -> torch.Tensor:
    """One fused E/M step, scatter-free; `prev` `[T]` or `[B, T]`."""
    lead = prev.shape[:-1]
    prev_ext = torch.nn.functional.pad(prev, (0, 1))

    # denominators: dense row reductions per bucket, concatenated in
    # relabeled read order before the (elementwise) guard and reciprocal
    denoms = [
        (prev_ext.index_select(-1, tt.reshape(-1)).reshape(*lead, *tt.shape)
         * ww).sum(dim=-1)
        for tt, ww in zip(data.bucket_txp, data.bucket_w)
    ]
    denom = torch.cat(denoms, dim=-1) if denoms else prev.new_zeros((*lead, 0))
    scale = torch.where(denom > EM_DENOM_THRESH, 1.0 / denom, 0.0)
    if multiplicity is not None:
        scale = scale * multiplicity.to(prev.dtype)
    scale_ext = torch.nn.functional.pad(scale, (0, 1))

    # m-step: inc in CSC order, segmented sum via hierarchical cumsum-diff
    if data.use_pallas_gather:
        gathered = gather_rows(
            prev_ext, data.g_p0, data.g_code, data.g_table_rows,
        ).reshape(*lead, -1)
        contrib_csc = gathered * data.w_csc
    else:
        contrib_csc = prev_ext.index_select(-1, data.txp_csc) * data.w_csc
    inc = contrib_csc * scale_ext.index_select(-1, data.read_csc)
    return offset_sums(inc, data.off_tile, data.off_prev,
                       data.off_inner).to(prev.dtype)


def offset_sums(inc: torch.Tensor, off_tile: torch.Tensor,
                off_prev: torch.Tensor, off_inner: torch.Tensor
                ) -> torch.Tensor:
    """Sums of `inc` (last axis a multiple of TILE) between consecutive
    offsets (`offset_tables`): a tile-local cumsum plus the double-double
    prefix of the tile totals, differenced at the offsets."""
    lead = inc.shape[:-1]
    local = torch.cumsum(inc.reshape(*lead, -1, TILE), dim=-1)
    g_hi, g_lo = exclusive_tile_prefix(local[..., -1])
    # exclusive prefix S(pos) = sum(inc[:pos]) at the T+1 offsets: the
    # prefix of the tiles before pos, plus the in-tile cumsum that ends
    # at pos-1 unless pos sits on a tile boundary
    within = torch.where(
        off_inner,
        local.reshape(*lead, -1).index_select(-1, off_prev),
        0.0,
    )
    hi = g_hi.index_select(-1, off_tile)
    lo = g_lo.index_select(-1, off_tile) + within
    return (hi[..., 1:] - hi[..., :-1]) + (lo[..., 1:] - lo[..., :-1])


def run_em_fast(
    data: FastEmData,
    init: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    multiplicity: Optional[torch.Tensor] = None,
    min_iters: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same loop semantics as `em.run_em` (`em.rs:144-255`)."""

    def m_step(p):
        return _m_step_fast(data, p, multiplicity)

    prev, niter = em_loop(m_step, init, max_iter, convergence_thresh, min_iters)
    return finish_em(m_step, prev), niter


def run_em_fast_squarem(
    data: FastEmData,
    init: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    multiplicity: Optional[torch.Tensor] = None,
    min_iters: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`run_em_fast` with SQUAREM acceleration (`em.squarem_em`)."""
    return squarem_em(
        lambda p: _m_step_fast(data, p, multiplicity),
        init, max_iter, convergence_thresh, min_iters,
    )


def replicate_step(data: FastEmData, max_iter: int, convergence_thresh: float,
                   accel: str = "none") -> BatchStep:
    """The scatter-free EM's `BatchStep`, the multiplicities `[n, R]` in
    `read_order`."""
    return BatchStep(lambda prev, mult: _m_step_fast(data, prev, mult),
                     max_iter, convergence_thresh, accel)
