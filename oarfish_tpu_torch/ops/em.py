"""Device EM: the sparse E/M fixed-point iteration on torch tensors.

Counterpart of the JAX package's `ops/em.py`. The per-read CSR is flattened
into segment operations:

  e-step   gather `prev[txp] * w`, per-read denominators via a segmented
           sum over the (sorted) read ids
  m-step   per-transcript segmented sum of `contrib/denom` over a
           precomputed sort-by-transcript permutation
  stop     signed max relative diff over transcripts with prev > 1e-5,
           `< thresh` only after iteration 50 (`em.rs:194-212`)

Both segmented sums go through `torch.segment_reduce` over CSR offsets:
each segment is added up by one thread in index order, so a run is
bit-reproducible (`index_add_`/`scatter_add_` use float atomics on CUDA
and are not).

Where the JAX package compiles the loop with `lax.while_loop` and gets
replicates with `vmap`, the loops here are Python loops and the replicate
axis is written out: every function takes `prev` as `[T]` or `[B, T]`,
and a batched loop freezes each replicate at its own stopping point. The
loop state lives on the device; the host reads one boolean per iteration
once early stopping has become possible.

A batch of B replicates is laid out `[B, A_pad]` and flattened, so that
each replicate's segments are 1-D segments of their own (`BatchSegments`).
A 2-D segment sum over `[A, B]` walks each (segment, replicate) pair with
one thread on the card, and adds in another order than the 1-D sum of a
single run: on a CSR of 6.0 M alignments whose most popular transcript
holds a quarter of them, a batch m-step of 8 took 168 ms that way against
3 ms for one replicate (one H100). `A_pad` rounds A up to
`SEGMENT_ALIGN`, so a replicate's segments start at the same alignment as
the single run's: replicate b has the bits of its run alone. A batched
loop makes its layout once, before its first m-step, and drops it when
it returns.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..constants import EM_DENOM_THRESH, MIN_READ_THRESH
from ..device import resolve_device

ALPHA_MAX = 64.0
# no loop stops early while niter <= MIN_ITERS (`em.rs:194-212`)
MIN_ITERS = 50
# a replicate's alignments start at a multiple of this many elements in a
# batch (512 bytes in f32, the caching allocator's alignment), so that the
# card's segment sums load each of its segments as they do a single run's
SEGMENT_ALIGN = 128


def csr_offsets(sorted_ids: np.ndarray, num_segments: int) -> np.ndarray:
    """[num_segments+1] i64 offsets of a sorted id array."""
    offsets = np.zeros(num_segments + 1, dtype=np.int64)
    np.cumsum(np.bincount(sorted_ids, minlength=num_segments), out=offsets[1:])
    return offsets


@dataclass(frozen=True)
class EmData:
    """Device-resident CSR for the EM (static across iterations)."""

    txp_id: torch.Tensor  # i32 [A]
    weights: torch.Tensor  # f32/f64 [A]: as_prob * cov_prob * dens_prob
    read_id: torch.Tensor  # i32 [A], sorted ascending (CSR expansion)
    txp_sort_perm: torch.Tensor  # i32 [A]: argsort(txp_id, stable)
    txp_id_sorted: torch.Tensor  # i32 [A]: txp_id[txp_sort_perm]
    read_offsets: torch.Tensor  # i64 [R+1]: CSR offsets of read_id
    txp_offsets: torch.Tensor  # i64 [T+1]: CSR offsets of txp_id_sorted
    num_reads: int
    num_txps: int

    @property
    def device(self) -> torch.device:
        return self.weights.device

    @staticmethod
    def build(
        txp_id: np.ndarray,
        weights: np.ndarray,
        read_id: np.ndarray,
        num_reads: int,
        num_txps: int,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> "EmData":
        """`device=None` is the package default (`cuda`; raises without a
        card), `"cpu"` is the host on request."""
        device = resolve_device(device)
        txp_id = np.asarray(txp_id)
        read_id = np.asarray(read_id)
        perm = np.argsort(txp_id, kind="stable").astype(np.int32)
        txp_sorted = txp_id[perm]

        def i32(a):
            return torch.as_tensor(
                np.ascontiguousarray(a, dtype=np.int32), device=device
            )

        return EmData(
            txp_id=i32(txp_id),
            weights=torch.as_tensor(
                np.asarray(weights, dtype=np.float64), device=device
            ).to(dtype),
            read_id=i32(read_id),
            txp_sort_perm=i32(perm),
            txp_id_sorted=i32(txp_sorted),
            read_offsets=torch.as_tensor(
                csr_offsets(read_id, int(num_reads)), device=device
            ),
            txp_offsets=torch.as_tensor(
                csr_offsets(txp_sorted, int(num_txps)), device=device
            ),
            num_reads=int(num_reads),
            num_txps=int(num_txps),
        )


def _batch_offsets(offsets: torch.Tensor, B: int, a_pad: int) -> torch.Tensor:
    """The CSR `offsets` of one replicate repeated for B replicates, the
    b-th shifted by `b * a_pad`, and the end of the last: each replicate
    gets its N segments and one more over its pad, `B * (N + 1)` in all."""
    shift = torch.arange(B, dtype=offsets.dtype, device=offsets.device)
    flat = (offsets.unsqueeze(0) + shift.unsqueeze(1) * a_pad).reshape(-1)
    end = torch.tensor([B * a_pad], dtype=offsets.dtype, device=offsets.device)
    return torch.cat([flat, end])


@dataclass(frozen=True)
class BatchSegments:
    """A batch of B replicates as `[B, a_pad]` flattened (module
    docstring). The gathers along the alignments are padded to `a_pad`
    with index 0 and weight 0, so the pad holds zeros; the segment sums
    run over the shifted offsets, whose extra segment per replicate covers
    its pad and is dropped. It holds 4 `[a_pad]` copies and `B * (R + T)`
    offsets: at 6.0 M alignments, 2 M reads and B = 8 about 240 MB."""

    txp_id: torch.Tensor  # i32 [a_pad]
    weights: torch.Tensor  # [a_pad], the pad 0
    read_id: torch.Tensor  # i32 [a_pad]
    txp_sort_perm: torch.Tensor  # i32 [a_pad], the pad maps to itself
    read_offsets: torch.Tensor  # i64 [B * (R + 1) + 1]
    txp_offsets: torch.Tensor  # i64 [B * (T + 1) + 1]
    a_pad: int
    num_rows: int  # B

    @staticmethod
    def build(data: EmData, B: int) -> "BatchSegments":
        A = data.txp_id.shape[0]
        a_pad = -(-A // SEGMENT_ALIGN) * SEGMENT_ALIGN
        pad = a_pad - A

        def padded(x, fill):
            return torch.nn.functional.pad(x, (0, pad), value=fill)

        tail = torch.arange(A, a_pad, dtype=data.txp_sort_perm.dtype,
                            device=data.device)
        return BatchSegments(
            txp_id=padded(data.txp_id, 0),
            weights=padded(data.weights, 0.0),
            read_id=padded(data.read_id, 0),
            txp_sort_perm=torch.cat([data.txp_sort_perm, tail]),
            read_offsets=_batch_offsets(data.read_offsets, B, a_pad),
            txp_offsets=_batch_offsets(data.txp_offsets, B, a_pad),
            a_pad=a_pad,
            num_rows=B,
        )

    def head(self, data: EmData, B: int) -> "BatchSegments":
        """The layout of this batch's first B replicates: the offsets of
        replicate B start where a batch of B ends."""
        if B == self.num_rows:
            return self
        return replace(
            self,
            read_offsets=self.read_offsets[:B * (data.num_reads + 1) + 1],
            txp_offsets=self.txp_offsets[:B * (data.num_txps + 1) + 1],
            num_rows=B,
        )


def _segment_sum(x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Sum of the 1-D `x` over its CSR segments."""
    return torch.segment_reduce(x, "sum", offsets=offsets, axis=0, unsafe=True)


def _m_step(
    data: EmData,
    prev: torch.Tensor,
    multiplicity: Optional[torch.Tensor],
    seg: Optional[BatchSegments] = None,
) -> torch.Tensor:
    """One fused E/M step (`em.rs:87-133`). `prev` is `[T]` or `[B, T]`,
    `multiplicity` `[R]` or `[B, R]` to match; a batch runs on `seg`'s
    flattened segments, made here when none is given."""
    if prev.dim() == 1:
        contrib = prev.index_select(0, data.txp_id) * data.weights
        denom = _segment_sum(contrib, data.read_offsets)
        num = 1.0 if multiplicity is None else multiplicity.to(prev.dtype)
        scale = torch.where(denom > EM_DENOM_THRESH, num / denom, 0.0)
        inc = contrib * scale.index_select(0, data.read_id)
        return _segment_sum(
            inc.index_select(0, data.txp_sort_perm), data.txp_offsets
        )
    B, R, T = prev.shape[0], data.num_reads, data.num_txps
    if seg is None:
        seg = BatchSegments.build(data, B)
    contrib = prev.index_select(1, seg.txp_id) * seg.weights
    denom = _segment_sum(contrib.reshape(-1), seg.read_offsets)
    denom = denom.view(B, R + 1)[:, :R]
    num = 1.0 if multiplicity is None else multiplicity.to(prev.dtype)
    scale = torch.where(denom > EM_DENOM_THRESH, num / denom, 0.0)
    inc = contrib * scale.index_select(1, seg.read_id)
    curr = _segment_sum(
        inc.index_select(1, seg.txp_sort_perm).reshape(-1), seg.txp_offsets
    )
    return curr.view(B, T + 1)[:, :T].contiguous()


def _rel_diff(prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
    """Signed max relative diff over transcripts with prev > 1e-5
    (`em.rs:194-201`), along the last axis; 0 when no transcript
    qualifies."""
    mask = prev > MIN_READ_THRESH
    safe_prev = torch.where(mask, prev, 1.0)
    rd = torch.where(mask, (curr - prev) / safe_prev, -torch.inf)
    return rd.amax(dim=-1).clamp_min(0.0)


MStep = Callable[[torch.Tensor], torch.Tensor]


def make_m_step(
    data: EmData, init: torch.Tensor, multiplicity: Optional[torch.Tensor]
) -> MStep:
    """`_m_step` for a loop started at `init`: a batch's layout is made
    here, once, and lives as long as the step."""
    seg = BatchSegments.build(data, init.shape[0]) if init.dim() == 2 else None
    return lambda p: _m_step(data, p, multiplicity, seg)


def _loop_state(init: torch.Tensor):
    shape = init.shape[:-1]
    niter = torch.zeros(shape, dtype=torch.int32, device=init.device)
    conv = torch.zeros(shape, dtype=torch.bool, device=init.device)
    return niter, conv


def em_cycle(m_step: MStep, t: torch.Tensor, niter: torch.Tensor,
             convergence_thresh: float, min_iters: int):
    """One plain EM step of a loop: (the step's result, the next state,
    converged by this step, niter after it). `niter > min_iters` is
    evaluated before the increment (`em.rs:194-212`)."""
    curr = m_step(t)
    newly = (_rel_diff(t, curr) < convergence_thresh) & (niter > min_iters)
    return curr, curr, newly, niter + 1


def squarem_cycle(m_step: MStep, t0: torch.Tensor, niter: torch.Tensor,
                  convergence_thresh: float, min_iters: int):
    """One cycle of squared-extrapolation EM acceleration (SQUAREM,
    Varadhan & Roland 2008, scheme S3):

        t1 = F(t0); t2 = F(t1)
        r = t1 - t0; v = (t2 - t1) - r
        alpha = -|r|/|v|  (clamped to [-ALPHA_MAX, -1])
        t' = max(t0 - 2 alpha r + alpha^2 v, 0);  t3 = F(t')

    costs 3 m-steps; alpha = -1 reduces to two plain steps. Returns (t1,
    t3, converged by this cycle, niter after it): the convergence measure
    is `_rel_diff` between the last two iterates, and `niter > min_iters`
    is evaluated after the cycle. A leading replicate axis gets an alpha
    per replicate."""
    tiny = float(torch.finfo(t0.dtype).tiny)
    t1 = m_step(t0)
    t2 = m_step(t1)
    r = t1 - t0
    v = (t2 - t1) - r
    rr = (r * r).sum(dim=-1, keepdim=True)
    vv = (v * v).sum(dim=-1, keepdim=True)
    alpha = -torch.sqrt(rr / vv.clamp_min(tiny))
    alpha = alpha.clamp(-ALPHA_MAX, -1.0)
    tp = t0 - 2.0 * alpha * r + (alpha * alpha) * v
    tp = tp.clamp_min(0.0)
    # degenerate curvature (v ~ 0: consecutive steps identical)
    # means t2 is already (numerically) the fixed point
    tp = torch.where(vv > tiny, tp, t2)
    t3 = m_step(tp)
    niter_new = niter + 3
    newly = (_rel_diff(tp, t3) < convergence_thresh) & (niter_new > min_iters)
    return t1, t3, newly, niter_new


# `--em-accel`: a loop's cycle, and the m-steps it takes
CYCLES = {"none": (em_cycle, 1), "squarem": (squarem_cycle, 3)}


def hold_frozen(conv, prev, niter, curr, stepped, newly):
    """A cycle's update of a loop's rows: those frozen before it (`conv`)
    keep their state and count, the others take the cycle's; returns
    (state, niter, frozen after it)."""
    prev = torch.where(conv.unsqueeze(-1), prev, curr)
    niter = torch.where(conv, niter, stepped)
    return prev, niter, conv | newly


def _cycle_loop(accel: str, m_step: MStep, init: torch.Tensor,
                max_iter: int, convergence_thresh: float, min_iters: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    cycle, k = CYCLES[accel]
    niter, conv = _loop_state(init)
    prev = init
    steps = 0
    while steps + k <= max_iter:
        # no replicate can have converged while niter <= min_iters, so
        # the device is only asked once early stopping is possible
        if steps > min_iters and bool(conv.all()):
            break
        _, curr, newly, stepped = cycle(m_step, prev, niter,
                                        convergence_thresh, min_iters)
        prev, niter, conv = hold_frozen(conv, prev, niter, curr, stepped,
                                        newly)
        steps += k
    return prev, niter


def em_loop(
    m_step: MStep,
    init: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    min_iters: int = MIN_ITERS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain EM loop shared by every formulation: returns
    (abundances before the final step, niter). With a leading replicate
    axis each replicate keeps its own `niter` and stops updating once it
    has converged or reached `max_iter`."""
    return _cycle_loop("none", m_step, init, max_iter, convergence_thresh,
                       min_iters)


def final_input(t: torch.Tensor,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The final step's input: abundances below MIN_READ_THRESH zeroed
    (`em.rs:238-252`), in every row or, with `rows` (`[B]` bool), in
    those rows alone."""
    small = t < MIN_READ_THRESH
    if rows is not None:
        small = rows.unsqueeze(-1) & small
    return torch.where(small, 0.0, t)


def finish_em(m_step: MStep, t: torch.Tensor) -> torch.Tensor:
    """Zero abundances below MIN_READ_THRESH, then one final step
    (`em.rs:238-252`)."""
    return m_step(final_input(t))


def run_em(
    data: EmData,
    init: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    multiplicity: Optional[torch.Tensor] = None,
    min_iters: int = MIN_ITERS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full EM loop (`em.rs:144-255`): fused E/M steps, early stop after
    `min_iters`, then zero tiny abundances and run one final step.
    Returns (counts, num_iterations); `init` `[B, T]` with
    `multiplicity` `[B, R]` runs B replicates at once."""
    m_step = make_m_step(data, init, multiplicity)
    prev, niter = em_loop(m_step, init, max_iter, convergence_thresh, min_iters)
    return finish_em(m_step, prev), niter


def squarem_loop(
    m_step: MStep,
    init: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    min_iters: int = MIN_ITERS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SQUAREM loop (`squarem_cycle`) under `em_loop`'s protocol:
    niter counts m-step applications, `max_iter` is a hard cap on them
    (the loop may stop up to 2 short), and a leading replicate axis is
    handled per replicate."""
    return _cycle_loop("squarem", m_step, init, max_iter,
                       convergence_thresh, min_iters)


def squarem_em(
    m_step: MStep,
    init: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    min_iters: int = MIN_ITERS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full accelerated-EM protocol shared by every formulation: SQUAREM
    loop, zero-below-MIN_READ_THRESH, one final m-step."""
    t, niter = squarem_loop(
        m_step, init, max_iter, convergence_thresh, min_iters
    )
    return finish_em(m_step, t), niter


def run_em_squarem(
    data: EmData,
    init: torch.Tensor,
    max_iter: int,
    convergence_thresh: float,
    multiplicity: Optional[torch.Tensor] = None,
    min_iters: int = MIN_ITERS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`run_em` with SQUAREM acceleration (see `squarem_cycle`)."""
    return squarem_em(
        make_m_step(data, init, multiplicity),
        init, max_iter, convergence_thresh, min_iters,
    )


@dataclass(frozen=True)
class BatchStep:
    """A formulation's batched m-step, as the bootstrap pool
    (`bootstrap.run_replicates`) drives it. `m_step(prev[B, S],
    mult[B, ...]) -> [B, S]` takes any B >= 1 and gives each row the
    values of its replicate's step alone; `mult(rows)` puts `[n, R]`
    multiplicities (on the device, in the start's dtype) in the form
    `m_step` takes, replicates on the leading axis; `start(init[T]) ->
    [S]` is the state a replicate starts from, whose first T entries are
    its counts. The loop's settings are those of the formulation's
    `run_em*` with `accel` (`--em-accel`), at `MIN_ITERS`."""

    m_step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    max_iter: int
    convergence_thresh: float
    accel: str = "none"
    mult: Callable[[torch.Tensor], torch.Tensor] = lambda m: m
    start: Callable[[torch.Tensor], torch.Tensor] = lambda init: init


def replicate_step(data: EmData, max_iter: int, convergence_thresh: float,
                   accel: str = "none") -> BatchStep:
    """The segment-sum EM's `BatchStep`: the flattened layout of the
    largest batch it has been given, whose first B replicates serve a
    batch of B."""
    seg: List[BatchSegments] = []

    def m_step(prev, mult):
        B = prev.shape[0]
        if not seg or seg[0].num_rows < B:
            seg[:] = [BatchSegments.build(data, B)]
        return _m_step(data, prev, mult, seg[0].head(data, B))

    return BatchStep(m_step, max_iter, convergence_thresh, accel)


def uniform_init(
    data, dtype: torch.dtype, total_weight: Optional[float] = None
) -> torch.Tensor:
    """Uniform length-free initialization `total_reads / T`
    (`em.rs:160-167`), on the device of `data` (an `EmData` or a
    `FastEmData`)."""
    tw = float(total_weight if total_weight is not None else data.num_reads)
    return torch.full(
        (data.num_txps,), tw / data.num_txps, dtype=dtype, device=data.device
    )


def initial_abundances(
    data, init_abundances: Optional[np.ndarray], dtype: torch.dtype
) -> torch.Tensor:
    """The caller's starting point if given, else the uniform one."""
    if init_abundances is not None:
        return torch.as_tensor(
            np.asarray(init_abundances, dtype=np.float64), device=data.device
        ).to(dtype)
    return uniform_init(data, dtype)


def em(
    data: EmData,
    max_iter: int = 1000,
    convergence_thresh: float = 1e-3,
    init_abundances: Optional[np.ndarray] = None,
    accel: str = "none",
) -> Tuple[np.ndarray, int]:
    """Convenience entry: returns (counts ndarray f64, niter). Runs on
    the device and in the dtype of `data`."""
    init = initial_abundances(data, init_abundances, data.weights.dtype)
    run = run_em_squarem if accel == "squarem" else run_em
    counts, niter = run(data, init, max_iter, convergence_thresh)
    return counts.double().cpu().numpy(), int(niter)
