"""Sorted gather: `table[idx]` for a STATIC, SORTED index array.

Counterpart of the JAX package's `ops/gather_pallas.py`. The index array is
laid out `[n_rows, 128]` and row-split at pack time so that each row's
index span is < 128; every element then lives in one of two consecutive
rows of the `[S, 128]` view of the table (`t = r*128 + c`). The plan
stores, per output row, the base table row and, per element, one byte:
the lane in the low 7 bits and, in the top bit, whether the element sits
in `base + 1` (`code = lane | use_hi << 7`):

    out[r, l] = table[(base[r] + use_hi[r, l]) * 128 + lane[r, l]]

with 0 for a table row outside `[0, S)` (pad rows have `base = -2`) and
for an index at or past the table's length `n <= S*128`. The table is
read as it is, `[n]` or `[B, n]`: the JAX package pads it with zeros to
`S*128`, which gives the same values.

On a CUDA tensor `sorted_gather` launches the hand-written kernel
`csrc/sorted_gather.cu` (built at first use by `kernels/build.py`) or
raises; `sorted_gather_reference` is the same function in plain torch
indexing, used for CPU tensors and for comparisons.

All metadata is static (indices never change across EM iterations), so
the plan is built once at pack time.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils import trace

LANES = 128
CHUNK_ROWS = 256  # n_rows is padded to a multiple of this, as in the JAX plan
HI_BIT = 7  # the code's bit that says "in base + 1"; the lane is below it

_KERNEL_DTYPES = {torch.float32: "sorted_gather_f32",
                  torch.float64: "sorted_gather_f64"}
_ALIGN = 16  # the kernel reads codes as words, writes 16-byte vectors


def pack_code(lane, use_hi) -> np.ndarray:
    """The plan's one byte an element from a lane (0..127) and a row flag
    (0 or 1) of the same shape."""
    lane = np.asarray(lane)
    hi = np.asarray(use_hi).astype(np.int64)
    if lane.shape != hi.shape:
        raise ValueError(f"lane {lane.shape} and use_hi {hi.shape} differ")
    if lane.size and (lane.min() < 0 or lane.max() >= LANES):
        raise ValueError(f"lanes must lie in [0, {LANES})")
    if hi.size and (hi.min() < 0 or hi.max() > 1):
        raise ValueError("use_hi must be 0 or 1")
    return (lane.astype(np.int64) | (hi << HI_BIT)).astype(np.uint8)


def unpack_code(code: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lane, use_hi) of a code tensor, as int64."""
    code = code.long()
    return code & (LANES - 1), code >> HI_BIT


@dataclass(frozen=True)
class SortedGatherPlan:
    """Static routing for gathering `table[idx]` (idx sorted)."""

    base: torch.Tensor  # [n_rows] i32: each row's base table-row (<0 = pad)
    code: torch.Tensor  # [n_rows, 128] u8: lane | use_hi << 7
    src_pos: np.ndarray  # [n_rows*128] i64: original position (or -1 pad)
    n_rows: int
    table_rows: int  # S
    out_len: int  # n_rows * 128

    @staticmethod
    def build(
        idx_sorted: np.ndarray, table_size: int, device=None
    ) -> "SortedGatherPlan":
        """`device=None` is the package default (`cuda`; raises without a
        card), `"cpu"` is the host on request."""
        device = resolve_device(device)
        idx_sorted = np.asarray(idx_sorted, dtype=np.int64)
        A = len(idx_sorted)
        S = (table_size + LANES - 1) // LANES
        # S is rounded up to a multiple of 8 as in the JAX plan, so both
        # packages build identical tables
        S = ((S + 7) // 8) * 8

        # row-split: new 128-element row whenever the span would reach 128.
        # Row-at-a-time greedy (O(n_rows) python iterations, not O(A)).
        starts = []
        pos = 0
        while pos < A:
            first = idx_sorted[pos]
            # furthest element still within [first, first+128)
            hi = int(
                np.searchsorted(idx_sorted, first + LANES, side="left")
            )
            end = min(pos + LANES, hi, A)
            starts.append((pos, end))
            pos = end

        n_real = len(starts)
        n_rows = ((n_real + CHUNK_ROWS - 1) // CHUNK_ROWS) * CHUNK_ROWS
        ridx = np.zeros((n_rows, LANES), dtype=np.int64)
        rpos = np.full((n_rows, LANES), -1, dtype=np.int64)
        for i, (s, e) in enumerate(starts):
            k = e - s
            ridx[i, :k] = idx_sorted[s:e]
            ridx[i, k:] = idx_sorted[s]  # pad with the row's base index
            rpos[i, :k] = np.arange(s, e)
        r = ridx // LANES
        base = r.min(axis=1) if n_rows else np.zeros(0, np.int64)
        hi = r - base[:, None]
        assert hi.size == 0 or hi.max() <= 1, (
            "row splitting violated the 2-row invariant"
        )

        # rows beyond n_real are pure padding: base -2 puts both candidate
        # rows outside the table, so they emit zeros
        base_i32 = np.full(n_rows, -2, dtype=np.int32)
        base_i32[:n_real] = base[:n_real]

        return SortedGatherPlan(
            base=torch.as_tensor(base_i32, device=device),
            code=torch.as_tensor(pack_code(ridx % LANES, hi), device=device),
            src_pos=rpos.reshape(-1),
            n_rows=n_rows,
            table_rows=S,
            out_len=n_rows * LANES,
        )


def _check_table_and_code(table: torch.Tensor, code: torch.Tensor,
                          table_rows: int) -> None:
    """What both versions refuse: a code that is not one byte an element
    (an int32 lane, say), and a table longer than the plan's `S*128`."""
    if code.dtype != torch.uint8:
        raise TypeError(f"code must be torch.uint8, got {code.dtype}")
    if table.shape[-1] > table_rows * LANES:
        raise ValueError(
            f"table of {table.shape[-1]} entries does not fit "
            f"{table_rows} rows of {LANES}"
        )


def gather_rows_reference(
    table: torch.Tensor, base: torch.Tensor, code: torch.Tensor,
    table_rows: int,
) -> torch.Tensor:
    """Plain torch version of the kernel: `[.., n]` -> `[.., n_rows,
    128]`."""
    _check_table_and_code(table, code, table_rows)
    n = table.shape[-1]
    lane, hi = unpack_code(code)
    idx = (base.unsqueeze(-1).long() + hi) * LANES + lane
    valid = (idx >= 0) & (idx < n)
    lead = table.shape[:-1]
    vals = table.index_select(-1, idx.clamp(0, n - 1).reshape(-1))
    vals = vals.reshape(*lead, *code.shape)
    return torch.where(valid, vals, torch.zeros_like(vals))


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the table on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % _ALIGN:
        raise ValueError(f"{name} must be {_ALIGN}-byte aligned")


def _kernel_fn(dtype: torch.dtype):
    from ..kernels.build import cuda_library

    lib = cuda_library("sorted_gather")
    fn = getattr(lib, _KERNEL_DTYPES[dtype])
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int32, ctypes.c_int32, p]
        fn.restype = ctypes.c_int
    return fn


def gather_rows_cuda(
    table: torch.Tensor, base: torch.Tensor, code: torch.Tensor,
    table_rows: int,
) -> torch.Tensor:
    """Launch the CUDA kernel: `[n]` or `[B, n]` table (`n <= S*128`) ->
    `[n_rows, 128]` / `[B, n_rows, 128]` of the table's dtype. Raises on
    anything the kernel does not take and on a refused launch."""
    if not table.is_cuda:
        raise ValueError("gather_rows_cuda needs a CUDA tensor")
    if table.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"no sorted-gather kernel for {table.dtype}")
    if table.dim() not in (1, 2):
        raise ValueError(
            f"table must be [n] or [B, n], got {tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    _check_table_and_code(table, code, table_rows)
    if table_rows >= 2**31:
        raise ValueError(f"{table_rows} table rows are too many")
    dev = table.device
    n_rows = base.shape[0]
    _check("base", base, torch.int32, (n_rows,), dev)
    _check("code", code, torch.uint8, (n_rows, LANES), dev)
    batch = table.shape[0] if table.dim() == 2 else 1
    if n_rows * LANES >= 2**31 * 256:
        raise ValueError("output too large for one launch")
    out = torch.empty(
        (*table.shape[:-1], n_rows, LANES), dtype=table.dtype, device=dev
    )
    fn = _kernel_fn(table.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            table.data_ptr(), base.data_ptr(), code.data_ptr(),
            out.data_ptr(), n_rows, table.shape[-1], table_rows, batch,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"sorted_gather kernel launch failed: CUDA error {err}")
    trace.count("launch.sorted_gather")
    return out


def gather_rows(
    table: torch.Tensor, base: torch.Tensor, code: torch.Tensor,
    table_rows: int,
) -> torch.Tensor:
    """The kernel for a CUDA table, the plain version for a CPU table."""
    if table.is_cuda:
        return gather_rows_cuda(table, base, code, table_rows)
    return gather_rows_reference(table, base, code, table_rows)


def sorted_gather(table: torch.Tensor, plan: SortedGatherPlan) -> torch.Tensor:
    """Gather `table[idx]` for the plan's (sorted, static) indices; `table`
    is `[n]` or `[B, n]`. Returns the `[.., n_rows*128]` padded result;
    `plan.src_pos` maps positions back (-1 = padding)."""
    out = gather_rows(table, plan.base, plan.code, plan.table_rows)
    return out.reshape(*table.shape[:-1], plan.out_len)


def sorted_gather_reference(
    table: torch.Tensor, plan: SortedGatherPlan
) -> torch.Tensor:
    """`sorted_gather` in plain torch indexing, on any device."""
    out = gather_rows_reference(table, plan.base, plan.code, plan.table_rows)
    return out.reshape(*table.shape[:-1], plan.out_len)
