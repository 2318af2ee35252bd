"""The fused middle of the routed EM iteration.

Counterpart of `_make_middle_kernel` / `_run_middle_stage` in
`ops/static_permute.py` of the JAX package. Per read chunk j:

  1. route A's reduce stage (`route_stage.py`, with its mask) takes the
     chunk's quota tile `[R_q, 128]` to chunk space `[R_c, 128]`;
  2. every read owns K consecutive rows at one lane (K = 2^lvl a power of
     two, groups K-aligned). Its denominator is the balanced pairwise sum
     of those rows: a butterfly in which level s adds the partner at
     row XOR 2^(s-1), each row taking the level its `lvl` names (-1: no
     data). `scale = denom > EM_DENOM_THRESH ? 1/denom : 0`, the chunk is
     scaled by it and, for a bootstrap replicate, by `mult`;
  3. route B's expand stage takes the scaled chunk back to a quota tile
     `[R_q, 128]`.

The chunk never leaves the kernel between the two routes.

Replicate axis (the `B > 0` arm of the JAX kernel): the quota values of
either layout may carry a leading axis of B replicates; `mult` is then
`[B, n_chunks * R_c, 128]` (or none) and the output `[B, n_chunks * R_q,
128]`, while both routes' tables, the mask and `lvl` are shared. Replicate
b comes out exactly as a call without the axis gives it for `y[b]` and
`mult[b]`, in one launch.

On CUDA values `route_middle` launches the hand-written kernel
`csrc/route_middle.cu` (built at first use by `kernels/build.py`) or
raises; `route_middle_reference` is the same function in plain torch, the
butterfly written level by level over the whole tile as in the JAX
kernel, used for CPU tensors and for comparisons. The kernel sums a group
once, from its first row, and so relies on `lvl` being constant over each
aligned group of 2^lvl rows, which `em_v4._read_lvl_ids` guarantees; the
plain version does not.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .route_stage import (
    LANES,
    SHARED_LIMIT,
    check_operand,
    check_stage_tables,
    check_values,
    input_tiles,
    kernel_function,
    on_device,
    ptr,
    stage_apply_reference,
)

# number of kernel launches made by `route_middle` in this process, and how
# many of them carried a replicate axis
launch_count = 0
replicate_launch_count = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
ROUTE_MIDDLE_ARGS = [_P] * 15 + [_I, _I, _I, _I, _I, ctypes.c_double, _I, _P]


def route_middle_reference(
    y: torch.Tensor, lvl: torch.Tensor, a_r1, a_src, a_row, a_r2, a_mask,
    b_r1, b_src, b_row, b_r2, n_chunks: int, R_q: int, R_c: int,
    thresh: float, max_lvl: int, mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain torch version of the kernel: `[n_chunks * R_q, 128]`, behind
    the replicate axis where the values have one."""
    tiles = input_tiles(y, n_chunks, R_q)
    x = stage_apply_reference(tiles, a_r1, a_src, a_row, a_r2, a_mask)
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
    out = stage_apply_reference(xs, b_r1, b_src, b_row, b_r2, None)
    return out.reshape(*xs.shape[:-3], n_chunks * R_q, LANES)


def route_middle_cuda(
    y: torch.Tensor, lvl: torch.Tensor, a_r1, a_src, a_row, a_r2, a_mask,
    b_r1, b_src, b_row, b_r2, n_chunks: int, R_q: int, R_c: int,
    thresh: float, max_lvl: int, mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel, once whatever the number of replicates.
    Raises on anything it does not take and on a refused launch."""
    global launch_count, replicate_launch_count
    B, Q = check_values(y, n_chunks, R_q)
    lead = tuple(y.shape[:1]) if B else ()
    dev, i8 = y.device, torch.int8
    if not 0 <= max_lvl <= 11 or (1 << max_lvl) > R_c:
        raise ValueError(f"max_lvl {max_lvl} does not fit a chunk of {R_c} rows")
    check_operand("lvl", lvl, i8, (n_chunks * R_c, LANES), dev)
    check_stage_tables("a_", a_r1, a_src, a_row, a_r2, n_chunks, R_q, R_c, dev)
    check_operand("a_mask", a_mask, i8, (n_chunks, R_c, LANES), dev)
    check_stage_tables("b_", b_r1, b_src, b_row, b_r2, n_chunks, R_c, R_q, dev)
    if mult is not None:
        check_operand("mult", mult, y.dtype, (*lead, n_chunks * R_c, LANES),
                      dev)
    out = torch.empty((*lead, n_chunks * R_q, LANES), dtype=y.dtype,
                      device=dev)
    # the chunk sits in shared memory where a block can hold it, else in
    # a scratch area of its own in device memory (the replicates of a chunk
    # follow one another through it)
    scratch = None
    if R_c * LANES * y.element_size() > SHARED_LIMIT:
        scratch = torch.empty((n_chunks * R_c, LANES), dtype=y.dtype,
                              device=dev)
    # the replicate arm keeps every element's source here, found once
    sources = None
    if B:
        sources = torch.empty((n_chunks, (R_c + R_q) * LANES),
                              dtype=torch.int32, device=dev)
    fn = kernel_function("route_middle", y.dtype, ROUTE_MIDDLE_ARGS)
    with on_device(dev):
        err = fn(
            y.data_ptr(), lvl.data_ptr(), a_r1.data_ptr(),
            ptr(a_src) if R_q > LANES else None, a_row.data_ptr(),
            a_r2.data_ptr(), a_mask.data_ptr(), b_r1.data_ptr(),
            ptr(b_src) if R_c > LANES else None, b_row.data_ptr(),
            b_r2.data_ptr(), ptr(mult), out.data_ptr(), ptr(scratch),
            ptr(sources), n_chunks, R_q, R_c, Q, max_lvl, float(thresh), B,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"route_middle kernel launch failed: CUDA error {err}")
    launch_count += 1
    replicate_launch_count += 1 if B else 0
    return out


def route_middle(
    y: torch.Tensor, lvl: torch.Tensor, a_r1, a_src, a_row, a_r2, a_mask,
    b_r1, b_src, b_row, b_r2, n_chunks: int, R_q: int, R_c: int,
    thresh: float, max_lvl: int, mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel for CUDA values, the plain version for CPU values."""
    fn = route_middle_cuda if y.is_cuda else route_middle_reference
    return fn(y, lvl, a_r1, a_src, a_row, a_r2, a_mask, b_r1, b_src, b_row,
              b_r2, n_chunks, R_q, R_c, thresh, max_lvl, mult=mult)
