"""EM v3: the fully-static-routed iteration over the alignment space.

Counterpart of the JAX package's `ops/em_v3.py`; the host half (CSC and
sorted-gather plan, read buckets, the two bijections) is that module's, so
both packages build identical plans. Data flow per iteration (all routing
fixed when the layout is built):

  prev[T]  --sorted gather (K1)-->  contrib_csc
  contrib_csc  --GlobalPermute P1 (K2 twice)-->  the read-bucket layout
  row sums  -->  denom / scale per read  -->  broadcast over its slots
  scale slots  --GlobalPermute P2 (K2 twice)-->  scale at CSC positions
  inc = contrib_csc * scale_csc  --tile cumsum + dd prefix-->  curr[T]

Correctness hinges on two invariants: CSC pad slots carry w = 0 (so
anything routed into them multiplies to zero), and bucket pad slots
receive zeros through P1 (they route from zero-valued unused source
slots), so the row sums see exact denominators. The glue around the two
kernels (bucket sums, broadcast, transposes, cumsum) is plain torch, as it
is XLA outside any Pallas kernel in the JAX package.

The layout and the loop run in the run's dtype (f64 on the CPU, f32 on
the card; the JAX package is f32 only). There is no batch arm: bootstrap
replicates run one after another, as in the JAX package. Semantics match
the reference serial EM (`em.rs:144-255`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import EM_DENOM_THRESH
from ..device import resolve_device
from ..utils import trace
from .em import BatchStep, em_loop, finish_em, squarem_em
from .em_fast import TILE, offset_sums, offset_tables
from .sorted_gather import LANES, SortedGatherPlan, gather_rows
from .static_permute import (
    CH,
    GlobalPermute,
    GlobalPermutePlan,
    balanced_pad_routing,
)


@dataclass(frozen=True)
class EmV3Data:
    """Static device state of the routed v3 EM."""

    # the sorted prev-gather, its rows spread over the rounded row count
    g_base: torch.Tensor  # [g_rows] i32 base table row (-2: all-pad row)
    g_code: torch.Tensor  # [g_rows, 128] u8: lane | use_hi << 7
    w_csc: torch.Tensor  # [NPAD] weights in plan layout (pads 0)
    txp_offsets: torch.Tensor  # [T+1] i64 offsets in plan coordinates
    off_tile: torch.Tensor  # [T+1] i64 (`em_fast.offset_tables`)
    off_prev: torch.Tensor  # [T+1] i64
    off_inner: torch.Tensor  # [T+1] bool
    p1: GlobalPermutePlan  # csc -> bucket slots
    p2: GlobalPermutePlan  # bucket slots -> csc
    bucket_shapes: Tuple[Tuple[int, int], ...]  # (rows, K) per bucket
    bucket_starts: Tuple[int, ...]  # flat start per bucket
    g_rows: int
    g_table_rows: int
    num_tiles: int
    n_slots: int
    num_reads: int
    num_txps: int

    @property
    def device(self) -> torch.device:
        return self.w_csc.device

    @property
    def npad(self) -> int:
        return self.g_rows * LANES

    @staticmethod
    def build(
        txp_id: np.ndarray,
        weights: np.ndarray,
        boundaries: np.ndarray,
        num_txps: int,
        dtype: torch.dtype = torch.float32,
        device=None,
        debug: bool = False,
    ):
        """Returns (data, read_order) where `read_order[i]` is the original
        read of relabeled read i (multiplicities are given in that order),
        and with `debug` also the host tables of the JAX package's `dbg`.
        `device=None` is the package default (`cuda`; raises without a
        card), `"cpu"` is the host on request. Each build phase ends with a
        lap of the caller's span (`utils/trace.py`). Raises `ValueError` when
        a permute's quota degenerates (too few alignments)."""
        device = resolve_device(device)
        txp_id = np.asarray(txp_id, dtype=np.int64)
        weights = np.asarray(weights, dtype=np.float64)
        boundaries = np.asarray(boundaries, dtype=np.int64)
        R = len(boundaries) - 1
        A = len(txp_id)
        T = int(num_txps)
        sizes = np.diff(boundaries)

        # ---- CSC + sorted-gather plan (host tables only)
        order = np.argsort(txp_id, kind="stable")
        txp_sorted = txp_id[order]
        plan = SortedGatherPlan.build(txp_sorted, T + 1, device="cpu")
        L = plan.out_len
        trace.lap("gather_plan")

        # ---- read buckets (as em_fast): rows relabeled contiguous
        maxk = int(sizes.max()) if R else 1
        ks = []
        K = 1
        while K < maxk:
            ks.append(K)
            K *= 2
        ks.append(max(K, 1))
        bucket_shapes = []
        bucket_starts = []
        order_parts = []
        slot_of_aln = np.zeros(A, dtype=np.int64)
        n_slots = 0
        lo = 0
        rng_rows = np.random.default_rng(3)
        for K in ks:
            rows = np.nonzero((sizes > lo) & (sizes <= K))[0]
            lo = K
            if len(rows) == 0:
                continue
            # shuffle row order within the bucket: the CSC order is
            # read-ordered within each transcript, so hot transcripts'
            # single-alignment reads would otherwise map consecutive CSC
            # positions to consecutive bucket slots and concentrate the
            # permute quota into single (src, dst) chunk pairs
            rows = rng_rows.permutation(rows)
            bucket_starts.append(n_slots)
            bucket_shapes.append((len(rows), K))
            row_sizes = sizes[rows]
            rep = np.repeat(np.arange(len(rows)), row_sizes)
            col = (
                np.arange(int(row_sizes.sum()))
                - np.repeat(
                    np.concatenate([[0], np.cumsum(row_sizes)[:-1]]),
                    row_sizes,
                )
            )
            src = np.repeat(boundaries[rows], row_sizes) + col
            slot_of_aln[src] = n_slots + rep * K + col
            order_parts.append(rows)
            n_slots += len(rows) * K
        read_order = (
            np.concatenate(order_parts) if order_parts else np.empty(0, np.int64)
        )
        trace.lap("read_buckets")

        # ---- rounded layout: the gather plan's rows SPREAD evenly over
        # the rounded row count, all-pad rows (base -2: zeros, w_csc 0)
        # interleaved, so that no contiguous zero tail concentrates whole
        # pad chunks into single (src, dst) quota pairs
        NPAD = ((max(L, n_slots) + 2 * CH - 1) // (2 * CH)) * (2 * CH)
        S = plan.table_rows
        NR = NPAD // LANES
        n_old = plan.n_rows
        new_of_old = (np.arange(n_old, dtype=np.int64) * NR) // n_old
        g_base = np.full(NR, -2, dtype=np.int32)
        g_base[new_of_old] = plan.base.numpy()
        g_code = np.zeros((NR, LANES), dtype=np.uint8)
        g_code[new_of_old] = plan.code.numpy()
        src_pos = np.full((NR, LANES), -1, dtype=np.int64)
        src_pos[new_of_old] = plan.src_pos.reshape(n_old, LANES)
        src_pos = src_pos.reshape(-1)

        mask = src_pos >= 0
        w_csc = np.zeros(NPAD, dtype=np.float64)
        w_csc[mask] = weights[order][src_pos[mask]]
        # csc position of each sorted element / of alignment a
        pos_of_sorted = np.zeros(A, dtype=np.int64)
        pos_of_sorted[src_pos[mask]] = np.nonzero(mask)[0]
        csc_pos = np.zeros(A, dtype=np.int64)
        csc_pos[order] = pos_of_sorted

        counts = np.bincount(txp_id, minlength=T)
        offsets = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        inv = np.zeros(A + 1, dtype=np.int64)
        inv[src_pos[mask]] = np.nonzero(mask)[0]
        inv[A] = NPAD
        offsets = inv[offsets]
        trace.lap("csc_layout")

        # ---- permutes (full-length bijections, flow-balanced pads)
        # P1: out[bucket_slot] = contrib_csc[csc_pos]; every other slot
        # routes a zero-valued source (csc pads have w = 0)
        perm1 = balanced_pad_routing(slot_of_aln, csc_pos, NPAD)
        trace.lap("pad_routing_p1")
        p1 = GlobalPermute(perm1, NPAD, device=device).plan
        trace.lap("permute_p1")
        # P2: out[csc_pos] = scale_slots[bucket_slot]; csc pads receive
        # unused bucket slots (multiplied by w = 0 downstream)
        perm2 = balanced_pad_routing(csc_pos, slot_of_aln, NPAD)
        trace.lap("pad_routing_p2")
        p2 = GlobalPermute(perm2, NPAD, device=device).plan
        trace.lap("permute_p2")

        def dev(a, to=None):
            t = torch.as_tensor(np.ascontiguousarray(a), device=device)
            return t if to is None else t.to(to)

        offsets_t = dev(offsets)
        off_tile, off_prev, off_inner = offset_tables(offsets_t)
        data = EmV3Data(
            g_base=dev(g_base),
            g_code=dev(g_code),
            w_csc=dev(w_csc, dtype),
            txp_offsets=offsets_t,
            off_tile=off_tile,
            off_prev=off_prev,
            off_inner=off_inner,
            p1=p1,
            p2=p2,
            bucket_shapes=tuple(bucket_shapes),
            bucket_starts=tuple(bucket_starts),
            g_rows=NR,
            g_table_rows=S,
            num_tiles=NPAD // TILE,
            n_slots=n_slots,
            num_reads=R,
            num_txps=T,
        )
        trace.lap("upload")
        if debug:
            dbg = {
                "perm1": perm1,
                "perm2": perm2,
                "src_pos": src_pos,
                "txp_sorted": txp_sorted,
                "w_csc": w_csc,
                "offsets": offsets,
                "slot_of_aln": slot_of_aln,
                "NPAD": NPAD,
            }
            return data, read_order, dbg
        return data, read_order


def _m_step_v3(data: EmV3Data, prev: torch.Tensor,
               multiplicity: Optional[torch.Tensor]) -> torch.Tensor:
    """One fused E/M step on `prev` `[T]`: one sorted gather and four tile
    permutes (two per GlobalPermute)."""
    prev_ext = torch.nn.functional.pad(prev, (0, 1))
    gathered = gather_rows(
        prev_ext, data.g_base, data.g_code, data.g_table_rows,
    ).reshape(-1)
    contrib_csc = gathered * data.w_csc

    # denominators in the bucket layout
    contrib_slots = data.p1(contrib_csc)[: data.n_slots]
    denoms = [
        contrib_slots[start : start + rows * K].view(rows, K).sum(dim=1)
        for (rows, K), start in zip(data.bucket_shapes, data.bucket_starts)
    ]
    denom = torch.cat(denoms) if denoms else prev.new_zeros(0)
    scale = torch.where(denom > EM_DENOM_THRESH, 1.0 / denom, 0.0)
    if multiplicity is not None:
        scale = scale * multiplicity.to(prev.dtype)
    # broadcast each read's scale across its K slots
    parts = []
    roff = 0
    for rows, K in data.bucket_shapes:
        parts.append(scale[roff : roff + rows, None].expand(rows, K)
                     .reshape(-1))
        roff += rows
    scale_slots = torch.cat(parts) if parts else prev.new_zeros(0)
    scale_csc = data.p2(scale_slots)[: contrib_csc.shape[0]]

    inc = contrib_csc * scale_csc
    return offset_sums(inc, data.off_tile, data.off_prev,
                       data.off_inner).to(prev.dtype)


def run_em_v3(
    data: EmV3Data,
    init: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    multiplicity: Optional[torch.Tensor] = None,
    min_iters: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same loop semantics as `em.run_em` (`em.rs:144-255`); `init` `[T]`,
    `multiplicity` `[R]` in `read_order`."""

    def m_step(p):
        return _m_step_v3(data, p, multiplicity)

    prev, niter = em_loop(m_step, init.to(data.w_csc.dtype), max_iter,
                          convergence_thresh, min_iters)
    return finish_em(m_step, prev), niter


def run_em_v3_squarem(
    data: EmV3Data,
    init: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    multiplicity: Optional[torch.Tensor] = None,
    min_iters: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`run_em_v3` with SQUAREM acceleration (`em.squarem_em`)."""
    return squarem_em(
        lambda p: _m_step_v3(data, p, multiplicity),
        init.to(data.w_csc.dtype), max_iter, convergence_thresh, min_iters,
    )


def replicate_step(data: EmV3Data, max_iter: int, convergence_thresh: float,
                   accel: str = "none") -> BatchStep:
    """v3's `BatchStep`: no batch arm, so the rows of a batch run one
    after another (the CLI gives it batches of one)."""

    def m_step(prev, mult):
        return torch.stack([_m_step_v3(data, p, m)
                            for p, m in zip(prev, mult)])

    return BatchStep(m_step, max_iter, convergence_thresh, accel,
                     start=lambda init: init.to(data.w_csc.dtype))


def make_runner(data: EmV3Data, accel: str = "none"):
    """`run(init, max_iter, convergence_thresh, multiplicity=None,
    min_iters=50)` on `data`; `accel="squarem"` runs the
    squared-extrapolation loop."""
    run = run_em_v3_squarem if accel == "squarem" else run_em_v3

    def run_em_v3_on(init, max_iter, convergence_thresh, multiplicity=None,
                     min_iters=50):
        return run(data, init, max_iter, convergence_thresh, multiplicity,
                   min_iters)

    return run_em_v3_on
