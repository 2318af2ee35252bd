"""The fused middle of the routed EM iteration.

Counterpart of `_make_middle_kernel` / `_run_middle_stage` in
`ops/static_permute.py` of the JAX package. Per read chunk j:

  1. route A's reduce stage (`a`, a `route_stage.Stage` with its mask)
     takes the chunk's quota tile `[R_q, 128]` to chunk space
     `[R_c, 128]`;
  2. every read owns K consecutive rows at one lane (K = 2^lvl a power of
     two, groups K-aligned). Its denominator is the balanced pairwise sum
     of those rows: a butterfly in which level s adds the partner at
     row XOR 2^(s-1), each row taking the level its `lvl` names (-1: no
     data). `scale = denom > EM_DENOM_THRESH ? 1/denom : 0`, the chunk is
     scaled by it and, for a bootstrap replicate, by `mult`;
  3. route B's expand stage (`b`) takes the scaled chunk back to a quota
     tile `[R_q, 128]`.

The chunk never leaves the kernel between the two routes. The two stages
are `GlobalRoutePlan.reduce_stage` of route A and `expand_stage` of route
B, checked and with their source offsets composed once, where the plan is
made.

Replicate axis (the `B > 0` arm of the JAX kernel): the quota values of
either layout may carry a leading axis of B replicates; `mult` is then
`[B, n_chunks * R_c, 128]` (or none) and the output `[B, n_chunks * R_q,
128]`, while both stages and `lvl` are shared. Replicate b comes out
exactly as a call without the axis gives it for `y[b]` and `mult[b]`, in
one launch.

On CUDA values `route_middle` launches the hand-written kernel
`csrc/route_middle.cu` (built at first use by `kernels/build.py`) or
raises; `route_middle_reference` is the same function in plain torch on
the stages' int8 tables, the butterfly written level by level over the
whole tile as in the JAX kernel, used for CPU tensors and for
comparisons. The kernel reads the stages' composed offsets and adds each
aligned block of rows once, as a tree; neither relies on a property of
the level table.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils import trace
from .route_stage import (
    LANES,
    SHARED_LIMIT,
    Stage,
    check_operand,
    check_values,
    input_tiles,
    kernel_function,
    on_device,
    ptr,
    q_inverse,
    stage_apply_reference,
)

# levels of the sum tree that one thread of the kernel adds in registers
# (a segment of 2^4 rows); the levels above sit in a tree area beside the
# chunk. Copies of SEG_LOG and MAX_LEVELS of csrc/route_middle.cu, as
# `tree_rows` is of its namesake there: the wrapper sizes a block's area
# with them.
SEGMENT_LEVELS = 4
MAX_LEVELS = 11

_P, _I = ctypes.c_void_p, ctypes.c_int
# y, lvl, off_a, a_bytes, off_b, b_bytes, mult, out, scratch, n_chunks,
# R_q, R_c, Q, q_inv, max_lvl, thresh, B, stream
ROUTE_MIDDLE_ARGS = [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                     ctypes.c_uint64, _I, ctypes.c_double, _I, _P]


def check_stages(a: Stage, b: Stage) -> None:
    """Route A's reduce stage `[R_q, 128] -> [R_c, 128]` and route B's
    expand stage back, over the same chunks."""
    if (b.n_chunks, b.R_in, b.R_out) != (a.n_chunks, a.R_out, a.R_in):
        raise ValueError(
            f"stage b ({b.n_chunks} chunks, {b.R_in} -> {b.R_out} rows) "
            f"does not take stage a's output back ({a.n_chunks} chunks, "
            f"{a.R_in} -> {a.R_out} rows)")


def check_levels(max_lvl: int, R_c: int) -> None:
    """Every level's aligned blocks of rows tile a chunk."""
    if not 0 <= max_lvl <= MAX_LEVELS or R_c % (1 << max_lvl):
        raise ValueError(
            f"max_lvl {max_lvl} does not fit a chunk of {R_c} rows")


def route_middle_reference(
    y: torch.Tensor, lvl: torch.Tensor, a: Stage, b: Stage, thresh: float,
    max_lvl: int, mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain torch version of the kernel: `[n_chunks * R_q, 128]`, behind
    the replicate axis where the values have one."""
    check_stages(a, b)
    n_chunks, R_q, R_c = a.n_chunks, a.R_in, a.R_out
    tiles = input_tiles(y, n_chunks, R_q)
    x = stage_apply_reference(tiles, a.r1, a.src, a.row, a.r2, a.mask)
    level = lvl.reshape(n_chunks, R_c, LANES).long()
    zero = torch.zeros_like(x)
    denom = torch.where(level == 0, x, zero)
    rows = torch.arange(R_c, device=x.device).reshape(R_c, 1)
    acc = x
    for s in range(1, max_lvl + 1):
        m = 1 << (s - 1)
        up = torch.cat([acc[..., m:, :], acc[..., :m, :]], dim=-2)
        down = torch.cat([acc[..., -m:, :], acc[..., :-m, :]], dim=-2)
        # partners never cross an aligned 2^s block, so the rows that
        # wrap around are never selected
        acc = acc + torch.where((rows & m) != 0, down, up)
        denom = torch.where(level == s, acc, denom)
    limit = torch.tensor(thresh, dtype=x.dtype, device=x.device)
    scale = torch.where(denom > limit, 1.0 / denom, zero)
    xs = x * scale
    if mult is not None:
        xs = xs * mult.reshape(xs.shape)
    out = stage_apply_reference(xs, b.r1, b.src, b.row, b.r2, b.mask)
    return out.reshape(*xs.shape[:-3], n_chunks * R_q, LANES)


def tree_rows(R_c: int, max_lvl: int) -> int:
    """Rows of 128 lanes of the kernel's tree area beside a chunk: the sums
    of the levels from SEGMENT_LEVELS to max_lvl (none where a thread's
    segment holds every level)."""
    if max_lvl <= SEGMENT_LEVELS:
        return 0
    return sum(R_c >> s for s in range(SEGMENT_LEVELS, max_lvl + 1))


def middle_variant(dtype: torch.dtype, R_c: int, max_lvl: int) -> str:
    """Where the kernel keeps a chunk: "block" (its block's shared memory)
    where the chunk and its tree fit 227 KB, else "scratch" (an area of
    the block's own in device memory)."""
    work = (R_c + tree_rows(R_c, max_lvl)) * LANES * dtype.itemsize
    return "block" if work <= SHARED_LIMIT else "scratch"


def route_middle_cuda(
    y: torch.Tensor, lvl: torch.Tensor, a: Stage, b: Stage, thresh: float,
    max_lvl: int, mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel, once whatever the number of replicates.
    Raises on anything it does not take and on a refused launch."""
    n_chunks, R_q, R_c = a.n_chunks, a.R_in, a.R_out
    B, Q = check_values(y, n_chunks, R_q)
    dev = y.device
    if a.off.device != dev or b.off.device != dev:
        raise ValueError(f"the stages are on {a.off.device} and "
                         f"{b.off.device}, the values on {dev}")
    check_stages(a, b)
    check_levels(max_lvl, R_c)
    lead = tuple(y.shape[:1]) if B else ()
    check_operand("lvl", lvl, torch.int8, (n_chunks * R_c, LANES), dev)
    if mult is not None:
        check_operand("mult", mult, y.dtype, (*lead, n_chunks * R_c, LANES),
                      dev)
    out = torch.empty((*lead, n_chunks * R_q, LANES), dtype=y.dtype,
                      device=dev)
    # the chunk and its tree sit in shared memory where a block can hold
    # them, else in a scratch area of the block's own in device memory
    scratch = None
    if middle_variant(y.dtype, R_c, max_lvl) == "scratch":
        scratch = torch.empty(
            (n_chunks * max(B, 1), (R_c + tree_rows(R_c, max_lvl)) * LANES),
            dtype=y.dtype, device=dev)
    fn = kernel_function("route_middle", y.dtype, ROUTE_MIDDLE_ARGS)
    with on_device(dev):
        err = fn(
            y.data_ptr(), lvl.data_ptr(), a.off.data_ptr(),
            a.off.element_size(), b.off.data_ptr(), b.off.element_size(),
            ptr(mult), out.data_ptr(), ptr(scratch), n_chunks, R_q, R_c, Q,
            q_inverse(Q), max_lvl, float(thresh), max(B, 1),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"route_middle kernel launch failed: CUDA error {err}")
    trace.count("launch.route_middle")
    if B:
        trace.count("launch.route_middle.replicate")
    return out


def route_middle(
    y: torch.Tensor, lvl: torch.Tensor, a: Stage, b: Stage, thresh: float,
    max_lvl: int, mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel for CUDA values, the plain version for CPU values."""
    fn = route_middle_cuda if y.is_cuda else route_middle_reference
    return fn(y, lvl, a, b, thresh, max_lvl, mult=mult)
