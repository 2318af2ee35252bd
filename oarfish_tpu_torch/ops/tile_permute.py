"""A batch of static permutations of `[R, 128]` tiles.

Counterpart of `_make_kernel` / `_run_batch` in the JAX package's
`ops/static_permute.py`. Tile t of `x` (`[n_tiles * R, 128]`) is permuted
through the three-stage decomposition of `permute_plan.py`, stored as int8
tables (`static_permute.DeviceTilePlan`):

    s1[r, c] = x[r, r1[r, c]]
    s2[hd * 128 + r', c] = s1[src[hd, c, r'] * 128 + lane[hd, c, r'], c]
    out[r, c] = s2[r, r2[r, c]]

The JAX kernel has no replicate axis of its own (`vmap` adds a grid axis
there). Here `replicates = B` says that `x` holds B batches of the
`n_tiles` tiles one after another, `[B * n_tiles * R, 128]`; tile j of
every batch goes through tables j, in one launch.

On a CUDA tensor `tile_permute` launches the hand-written kernel
`csrc/tile_permute.cu` (built at first use by `kernels/build.py`) or
raises; `tile_permute_reference` is the same function with
`torch.take_along_dim`, used for CPU tensors and for comparisons.
"""

from __future__ import annotations

import ctypes

import torch

from .route_stage import (
    KERNEL_SUFFIX,
    LANES,
    check_operand,
    kernel_function,
    stage_apply_reference,
)

# number of kernel launches made by `tile_permute` in this process
launch_count = 0


def tile_permute_reference(
    x: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor, src: torch.Tensor,
    lane: torch.Tensor, rows: int, n_tiles: int, replicates: int = 1,
) -> torch.Tensor:
    """Plain torch version of the kernel: `[replicates * n_tiles * rows,
    128]`. The column stage is a gather-network stage whose input and
    output have the same number of blocks."""
    tiles = x.reshape(replicates, n_tiles, rows, LANES)
    src_tab = src if rows > LANES else None
    out = stage_apply_reference(tiles, r1, src_tab, lane, r2, None)
    return out.reshape(replicates * n_tiles * rows, LANES)


def tile_permute_cuda(
    x: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor, src: torch.Tensor,
    lane: torch.Tensor, rows: int, n_tiles: int, replicates: int = 1,
) -> torch.Tensor:
    """Launch the CUDA kernel, once whatever the number of replicates.
    Raises on anything it does not take and on a refused launch."""
    global launch_count
    if not x.is_cuda:
        raise ValueError("tile_permute_cuda needs a CUDA tensor")
    if x.dtype not in KERNEL_SUFFIX:
        raise TypeError(f"no tile-permute kernel for {x.dtype}")
    total = replicates * n_tiles
    if rows % LANES or replicates < 1 or total * rows * LANES >= 2**31:
        raise ValueError(f"unsupported tile batch: {replicates} x {n_tiles} "
                         f"x {rows} rows")
    dev, i8, H = x.device, torch.int8, rows // LANES
    check_operand("x", x, x.dtype, (total * rows, LANES), dev)
    check_operand("r1", r1, i8, (n_tiles, rows, LANES), dev)
    check_operand("r2", r2, i8, (n_tiles, rows, LANES), dev)
    check_operand("src", src, i8, (n_tiles, H, LANES, LANES), dev)
    check_operand("lane", lane, i8, (n_tiles, H, LANES, LANES), dev)
    out = torch.empty_like(x)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = kernel_function("tile_permute", x.dtype,
                         [p, p, p, p, p, p, i, i, i, p])
    with torch.cuda.device(dev):
        err = fn(
            x.data_ptr(), r1.data_ptr(), r2.data_ptr(), src.data_ptr(),
            lane.data_ptr(), out.data_ptr(), total, rows, n_tiles,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"tile_permute kernel launch failed: CUDA error {err}")
    launch_count += 1
    return out


def tile_permute(
    x: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor, src: torch.Tensor,
    lane: torch.Tensor, rows: int, n_tiles: int, replicates: int = 1,
) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    fn = tile_permute_cuda if x.is_cuda else tile_permute_reference
    return fn(x, r1, r2, src, lane, rows, n_tiles, replicates)
