"""Fixed-order row sums of the routed EM's slot layouts.

Counterpart of the glue's sums in the JAX package's `ops/em_v4.py`: the
bucket row sums (`_row_sums`, one reduction per bucket of the column-major
layout) and the big-transcript second level (differences of a `cumsum`
over the big region's row sums). There they are XLA reductions; torch's
counterparts on the card add in an order that depends on the number of
outputs, so a bootstrap replicate summed in a batch got other last bits
than the same replicate alone.

Here both are one function over a `RowSumTable`, whose entries
`(first output, first value, K, W)` each give outputs

    out[o] = x[a] + x[a + W] + ... + x[a + (K - 1) W],
    a = first value + (q // W) K W + q % W,   q = o - first output,

added in the values' dtype in a fixed order: windows of 32 values in
index order, then the window sums in windows of 32, and so on. That is the
order of XLA's CPU reduction, so for the power-of-two K of the layouts the
plain version gives the JAX package's bucket sums bit for bit, and the
kernel gives every replicate the same bits alone or in any batch. A bucket
of
`rows_pad` rows of K slots is one entry with W = 128 (`bucket_table`); a
run of consecutive values summed to one output is one entry with W = 1
(`segment_table`). Leading axes (replicates) are kept, and each replicate
gets the same bits alone or in any batch.

On a CUDA tensor `row_sums` launches the hand-written kernel
`csrc/row_sums.cu` (built at first use by `kernels/build.py`), one launch
for every entry of a table, or raises; `row_sums_reference` is the same
function with NumPy's `add.accumulate` (sequential by definition) over
each window, used for CPU tensors and for comparisons.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from .route_stage import KERNEL_SUFFIX, kernel_function, on_device

LANES = 128
WINDOW = 32  # values added in index order before their sum moves up a level
MAX_K = WINDOW ** 3  # the kernel's three levels

# number of kernel launches made by `row_sums` in this process
launch_count = 0

_P = ctypes.c_void_p
# x, x_stride, table, n_entries, n_out, B, out, stream
ROW_SUMS_ARGS = [_P, ctypes.c_int64, _P, ctypes.c_int, ctypes.c_int64,
                 ctypes.c_int, _P, _P]


@dataclass(frozen=True)
class RowSumTable:
    """Entries `[E, 4]` int64 (first output, first value, K, W), first
    outputs ascending from 0; `n_out` outputs in all; the values must hold
    at least `n_in` elements. Checked once, where it is made."""

    entries: np.ndarray
    n_out: int
    n_in: int
    device_entries: torch.Tensor

    @staticmethod
    def make(entries, n_out: int, device) -> "RowSumTable":
        e = np.asarray(entries, dtype=np.int64).reshape(-1, 4)
        ends = np.append(e[1:, 0], n_out)
        counts = ends - e[:, 0]
        if len(e) and (e[0, 0] != 0 or (counts <= 0).any()
                       or (e[:, 2] < 1).any() or (e[:, 3] < 1).any()
                       or (e[:, 2] > MAX_K).any()
                       or (counts % e[:, 3]).any() or (e[:, 1] < 0).any()):
            raise ValueError("row-sum table entries must cover the outputs "
                             f"in order, with 1 <= K <= {MAX_K}, W >= 1 and "
                             "whole rows")
        if not len(e) and n_out:
            raise ValueError("an empty row-sum table has no outputs")
        n_in = int((e[:, 1] + counts * e[:, 2]).max()) if len(e) else 0
        return RowSumTable(
            entries=e, n_out=int(n_out), n_in=n_in,
            device_entries=torch.as_tensor(e, device=device),
        )


def bucket_table(shapes: Sequence[Tuple[int, int]], starts: Sequence[int],
                 device) -> RowSumTable:
    """The row sums of a column-major bucket layout (`(rows_pad, K)` and
    the first slot of each bucket): output i of bucket b is the sum of its
    row i, the buckets one after another."""
    entries, off = [], 0
    for (rows_pad, K), start in zip(shapes, starts):
        entries.append((off, start, K, LANES))
        off += rows_pad
    return RowSumTable.make(entries, off, device)


def segment_table(offsets: np.ndarray, base: int, device) -> RowSumTable:
    """Sums of consecutive runs: output i is the sum of values
    `base + offsets[i]` to `base + offsets[i + 1] - 1`."""
    o = np.asarray(offsets, dtype=np.int64)
    n = len(o) - 1
    entries = np.stack([np.arange(n), base + o[:-1], np.diff(o),
                        np.ones(n, np.int64)], axis=1)
    return RowSumTable.make(entries, n, device)


def window_sum(v: np.ndarray) -> np.ndarray:
    """`v` `[L, n, K, W]` -> `[L, n, W]`, summed over K in the kernel's
    order. A short last window is padded with -0.0, which leaves every sum
    as it is."""
    while v.shape[2] > WINDOW:
        L, n, K, W = v.shape
        n1 = -(-K // WINDOW)
        if n1 * WINDOW > K:
            pad = np.full((L, n, n1 * WINDOW - K, W), -0.0, v.dtype)
            v = np.concatenate([v, pad], axis=2)
        v = v.reshape(L, n, n1, WINDOW, W)
        v = np.add.accumulate(v, axis=3)[:, :, :, -1, :]
    return np.add.accumulate(v, axis=2)[:, :, -1, :]


def row_sums_reference(x: torch.Tensor, table: RowSumTable) -> torch.Tensor:
    """Plain version of the kernel: `x` `[..., n]` -> `[..., n_out]` in
    the dtype of `x`, each output's values added in the kernel's order
    (`window_sum`). Computes on the host and returns on the device of
    `x`."""
    lead = x.shape[:-1]
    xs = x.detach().cpu().reshape(-1, x.shape[-1]).numpy()
    L = xs.shape[0]
    out = np.empty((L, table.n_out), dtype=xs.dtype)
    ends = np.append(table.entries[1:, 0], table.n_out)
    for (off, base, K, W), end in zip(table.entries.tolist(), ends.tolist()):
        count = end - off
        v = xs[:, base : base + count * K].reshape(L, count // W, K, W)
        out[:, off:end] = window_sum(v).reshape(L, count)
    return torch.from_numpy(out).reshape(*lead, table.n_out).to(x.device)


def _check(x: torch.Tensor, table: RowSumTable) -> None:
    if x.dtype not in KERNEL_SUFFIX:
        raise TypeError(f"no row-sum kernel for {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("values must be contiguous")
    if x.shape[-1] < table.n_in:
        raise ValueError(f"values of {x.shape[-1]} elements, the table "
                         f"reads {table.n_in}")
    if table.device_entries.device != x.device:
        raise ValueError(f"table on {table.device_entries.device}, values "
                         f"on {x.device}")


def row_sums_cuda(x: torch.Tensor, table: RowSumTable) -> torch.Tensor:
    """Launch the CUDA kernel once for every entry and replicate. Raises
    on anything it does not take and on a refused launch."""
    global launch_count
    if not x.is_cuda:
        raise ValueError("row_sums_cuda needs a CUDA tensor")
    _check(x, table)
    lead = x.shape[:-1]
    B = int(np.prod(lead, dtype=np.int64)) if lead else 1
    if B > 65535:
        raise ValueError(f"{B} replicates: more than one launch takes")
    out = torch.empty((*lead, table.n_out), dtype=x.dtype, device=x.device)
    if table.n_out == 0 or B == 0:
        return out
    fn = kernel_function("row_sums", x.dtype, ROW_SUMS_ARGS)
    dev = x.device
    with on_device(dev):
        err = fn(
            x.data_ptr(), x.shape[-1], table.device_entries.data_ptr(),
            len(table.entries), table.n_out, B, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"row_sums kernel launch failed: CUDA error {err}")
    launch_count += 1
    return out


def row_sums(x: torch.Tensor, table: RowSumTable) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return row_sums_cuda(x, table)
    _check(x, table)
    return row_sums_reference(x, table)
