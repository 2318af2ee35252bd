"""Fixed-order row sums of the routed EM's slot layouts.

Counterpart of the glue's sums in the JAX package's `ops/em_v4.py`: the
bucket row sums (`_row_sums`, one reduction per bucket of the column-major
layout), the big-transcript second level (differences of a `cumsum` over
the big region's row sums) and the zero tail that the output tile permute
takes. There they are XLA reductions; torch's counterparts on the card add
in an order that depends on the number of outputs, so a bootstrap
replicate summed in a batch got other last bits than the same replicate
alone.

A `RowSumTable`'s entries `(first output, first value, K, W)` each give
outputs

    out[o] = x[a] + x[a + W] + ... + x[a + (K - 1) W],
    a = first value + (q // W) K W + q % W,   q = o - first output,

added in the values' dtype in a fixed order: windows of 32 values in
index order, then the window sums in windows of 32, and so on. That is the
order of XLA's CPU reduction, so for the power-of-two K of the layouts the
plain version gives the JAX package's bucket sums bit for bit, and the
kernel gives every replicate the same bits alone or in any batch. A bucket
of `rows_pad` rows of K slots is one entry with W = 128 (`bucket_table`);
a run of consecutive values summed to one output is one entry with W = 1
(`segment_table`).

A `RowSumPlan` is what the kernel runs: a table's rows, optionally a
second level (groups of consecutive row sums, each added in the same
order into one output) and a zero tail, cut once into tiles of work
(`RowSumPlan.make`). The transcript tail of a v4 m-step is one plan
(`EmV4Data.tail_plan`) and one launch; a table alone runs as
`table.plan`. Leading axes (replicates) are kept, and the tiles do not
depend on them.

On a CUDA tensor `row_sums` launches the hand-written kernel
`csrc/row_sums.cu` (built at first use by `kernels/build.py`) once, or
raises; `row_sums_reference` and `plan_reference` are the same functions
with NumPy's `add.accumulate` (sequential by definition) over each window,
used for CPU tensors and for comparisons.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils import trace
from .route_stage import KERNEL_SUFFIX, kernel_function, on_device

LANES = 128
WINDOW = 32  # values added in index order before their sum moves up a level
MAX_K = WINDOW ** 3  # the kernel's three levels
THREADS = 512  # a block of the kernel: one tile
WS_SLOTS = 2048  # window sums a tile keeps in shared memory
MID_SLOTS = 64  # sums of 32 window sums a tile keeps there
LINE = 32  # neighbouring outputs of a W = 128 row that fill a 128-byte line
ZERO_SPAN = 8 * THREADS  # outputs of a zero tile
REPLICATE_CAP = 8  # replicates a plan's scratch is first made for

_P = ctypes.c_void_p
# x, x_stride, tiles, n_tiles, groups, n_groups, n_out, B, out, scratch,
# n_scratch, counters, stream
ROW_SUMS_ARGS = [_P, ctypes.c_int64, _P, ctypes.c_int, _P, ctypes.c_int,
                 ctypes.c_int64, ctypes.c_int, _P, _P, ctypes.c_int64, _P, _P]


@dataclass(frozen=True)
class RowSumTable:
    """Entries `[E, 4]` int64 (first output, first value, K, W), first
    outputs ascending from 0; `n_out` outputs in all; the values must hold
    at least `n_in` elements. Checked once, where it is made."""

    entries: np.ndarray
    n_out: int
    n_in: int
    device: torch.device

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
        # the device as tensors name it (`cuda:0` for `cuda`)
        return RowSumTable(entries=e, n_out=int(n_out), n_in=n_in,
                           device=torch.empty(0, device=device).device)

    @cached_property
    def plan(self) -> "RowSumPlan":
        """The table's rows as the kernel runs them."""
        return RowSumPlan.make(self)


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


def tile_lanes(K: int) -> int:
    """Outputs of a K-wide entry that one tile takes: as many as give the
    block's threads one window each, and at least a line's worth where
    the shared memory holds their window sums (up to 4 windows a thread);
    a power of two, so that tiles of a W = 128 bucket stay inside its
    groups of 128 rows."""
    windows = 1 << (-(-K // WINDOW) - 1).bit_length()
    return max(1, THREADS // windows, min(LINE, WS_SLOTS // windows))


@dataclass(frozen=True)
class RowSumPlan:
    """The work of one launch: the row sums of `table`; the table's outputs
    from `first` on are rows of a second level, whose group i (table
    outputs `first + offsets[i]` to `first + offsets[i + 1] - 1`) is added
    into output `first + i`; outputs from `first + groups` to `n_out` are
    zero. Without a second level `first` is `table.n_out`.

    `tiles` `[n, 7]` int64, one block each: (destination, first value,
    first row of the entry, lanes, K, W, group or -1): `lanes`
    neighbouring rows (`tile_lanes`) summed into the outputs from
    `destination`; K = 0 is a zero tile of `lanes` outputs. A tile of
    second-level rows writes its row sums to the scratch slots from
    `destination` instead, names the group of its first row, and may
    reach into the next groups. The second level's tiles come first, then
    the rows written straight out, then the zero tail. `groups` `[G, 4]`
    int64: (output, first scratch slot, rows, tiles whose rows fall in
    it). Made and checked once, where the layout is; on the device with a
    scratch area and arrival counters (zero between launches), which
    serve one stream at a time."""

    table: RowSumTable
    first: int
    offsets: np.ndarray
    n_out: int
    tiles: np.ndarray
    groups: np.ndarray
    values_read: int  # values the tiles read (rows of no group are skipped)
    device_tiles: torch.Tensor
    device_groups: torch.Tensor
    work: dict = field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def make(table: RowSumTable, n_out: Optional[int] = None,
             first: Optional[int] = None,
             offsets: Optional[np.ndarray] = None) -> "RowSumPlan":
        first = table.n_out if first is None else int(first)
        offsets = np.asarray([0] if offsets is None else offsets,
                             dtype=np.int64)
        G = len(offsets) - 1
        n_out = first + G if n_out is None else int(n_out)
        rows = np.diff(offsets)
        if (not 0 <= first <= table.n_out or offsets[0] != 0
                or (rows < 1).any() or (rows > MAX_K).any()
                or first + offsets[-1] > table.n_out or n_out < first + G):
            raise ValueError(
                "a second level must take groups of 1 to "
                f"{MAX_K} consecutive rows from the table's outputs, and "
                "the outputs must hold the rows before it and one sum for "
                "each group")
        bounds = first + offsets
        # tiles: (destination, first value, first row of the entry, lanes,
        # K, W, group); the second level's first
        grouped, direct = [], []
        ends = np.append(table.entries[1:, 0], table.n_out)
        for (off, base, K, W), end in zip(table.entries.tolist(),
                                          ends.tolist()):
            lanes = tile_lanes(K)

            def rec(dest, q, n, g):
                return np.stack(np.broadcast_arrays(
                    dest, base, q, n, K, W, g), axis=1)

            d_end = min(end, first)
            if d_end > off:
                s = np.arange(off, d_end, lanes)
                direct.append(rec(s, s - off, np.minimum(lanes, d_end - s),
                                  -1))
            lo, hi = max(off, first), min(end, int(bounds[-1]))
            if hi > lo:
                # aligned like the rows written out, across the groups
                s = np.unique(np.concatenate([
                    [lo], np.arange(off + -(-(lo - off) // lanes) * lanes,
                                    hi, lanes)]))
                g = np.searchsorted(bounds, s, side="right") - 1
                grouped.append(rec(s - first, s - off,
                                   np.diff(np.append(s, hi)), g))
        z = np.arange(first + G, n_out, ZERO_SPAN)
        zeros = np.stack(np.broadcast_arrays(
            z, 0, 0, np.minimum(ZERO_SPAN, n_out - z), 0, 1, -1), axis=1)
        tiles = np.concatenate(
            [*grouped, *direct, zeros.reshape(-1, 7)]).astype(np.int64)
        # tiles that count on each group's counter: those whose rows fall
        # in it
        gt = tiles[tiles[:, 6] >= 0]
        last = np.searchsorted(offsets, gt[:, 0] + gt[:, 3] - 1,
                               side="right") - 1
        need = np.cumsum(np.bincount(gt[:, 6], minlength=G + 1)
                         - np.bincount(last + 1, minlength=G + 1))[:G]
        groups = np.stack([first + np.arange(G), offsets[:-1], rows, need],
                          axis=1).astype(np.int64)
        if (need < 1).any() or len(tiles) >= 2**31:
            raise ValueError("the tiles must cover every group, in fewer "
                             "than 2^31 blocks")
        dev = table.device
        plan = RowSumPlan(
            table=table, first=first, offsets=offsets, n_out=n_out,
            tiles=tiles, groups=groups,
            values_read=int((tiles[:, 3] * tiles[:, 4]).sum()),
            device_tiles=torch.as_tensor(tiles, device=dev),
            device_groups=torch.as_tensor(groups, device=dev))
        plan.workspace(REPLICATE_CAP)
        return plan

    @property
    def n_in(self) -> int:
        return self.table.n_in

    @property
    def device(self) -> torch.device:
        return self.table.device

    @cached_property
    def second(self) -> RowSumTable:
        """The second level as a table over the first level's outputs."""
        return segment_table(self.offsets, self.first, "cpu")

    def workspace(self, B: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scratch, counters) for B replicates: the groups' row sums (f64
        slots, taken as f32 ones in f32) and arrival counters, zero. Made
        with the plan for `REPLICATE_CAP` replicates and made again, once,
        for a larger batch."""
        if B > self.work.get("cap", 0):
            cap = max(B, REPLICATE_CAP)
            self.work.update(
                cap=cap,
                scratch=torch.empty((cap, max(int(self.offsets[-1]), 1)),
                                    dtype=torch.float64, device=self.device),
                counters=torch.zeros((cap, max(len(self.groups), 1)),
                                     dtype=torch.int32, device=self.device))
        return self.work["scratch"], self.work["counters"]


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
    """Plain version of a table's rows: `x` `[..., n]` -> `[..., n_out]` in
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


def plan_reference(x: torch.Tensor, plan: RowSumPlan) -> torch.Tensor:
    """Plain version of a plan: the table's row sums up to `first`, the
    second level's group sums over the rest, then zeros to `n_out`."""
    sums = row_sums_reference(x.detach().cpu(), plan.table)
    lead = sums.shape[:-1]
    G = len(plan.groups)
    parts = [sums[..., : plan.first]]
    if G:
        parts.append(row_sums_reference(sums, plan.second))
    parts.append(sums.new_zeros((*lead, plan.n_out - plan.first - G)))
    return torch.cat(parts, dim=-1).to(x.device)


Sums = Union[RowSumTable, RowSumPlan]


def _plan(what: Sums) -> RowSumPlan:
    return what.plan if isinstance(what, RowSumTable) else what


def _check(x: torch.Tensor, plan: RowSumPlan) -> None:
    if x.dtype not in KERNEL_SUFFIX:
        raise TypeError(f"no row-sum kernel for {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("values must be contiguous")
    if x.shape[-1] < plan.n_in:
        raise ValueError(f"values of {x.shape[-1]} elements, the table "
                         f"reads {plan.n_in}")
    if plan.device != x.device:
        raise ValueError(f"plan on {plan.device}, values on {x.device}")


def row_sums_cuda(x: torch.Tensor, what: Sums) -> torch.Tensor:
    """Launch the CUDA kernel once for a plan (or a table's rows) and every
    replicate. Raises on anything it does not take and on a refused
    launch."""
    if not x.is_cuda:
        raise ValueError("row_sums_cuda needs a CUDA tensor")
    plan = _plan(what)
    _check(x, plan)
    lead = x.shape[:-1]
    B = int(np.prod(lead, dtype=np.int64)) if lead else 1
    if B > 65535:
        raise ValueError(f"{B} replicates: more than one launch takes")
    out = torch.empty((*lead, plan.n_out), dtype=x.dtype, device=x.device)
    if plan.n_out == 0 or B == 0:
        return out
    scratch, counters = plan.workspace(B)
    fn = kernel_function("row_sums", x.dtype, ROW_SUMS_ARGS)
    dev = x.device
    with on_device(dev):
        err = fn(
            x.data_ptr(), x.shape[-1], plan.device_tiles.data_ptr(),
            len(plan.tiles), plan.device_groups.data_ptr(),
            len(plan.groups), plan.n_out, B, out.data_ptr(),
            scratch.data_ptr(), scratch.shape[-1], counters.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"row_sums kernel launch failed: CUDA error {err}")
    trace.count("launch.row_sums")
    return out


def row_sums(x: torch.Tensor, what: Sums) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    plan = _plan(what)
    if x.is_cuda:
        return row_sums_cuda(x, plan)
    _check(x, plan)
    return plan_reference(x, plan)
