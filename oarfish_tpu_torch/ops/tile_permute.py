"""A batch of static permutations of `[R, 128]` tiles.

Counterpart of `_make_kernel` / `_run_batch` in the JAX package's
`ops/static_permute.py`. Tile t of `x` (`[n_tiles * R, 128]`) is permuted
through the three-stage decomposition of `permute_plan.py`, stored as int8
tables (`static_permute.DeviceTilePlan`):

    s1[r, c] = x[r, r1[r, c]]
    s2[hd * 128 + r', c] = s1[src[hd, c, r'] * 128 + lane[hd, c, r'], c]
    out[r, c] = s2[r, r2[r, c]]

That is a gather-network stage with as many input as output rows, so the
tables travel as a `route_stage.Stage` (`row` = `lane`, no mask), which
checks them and composes each element's source offset once.

The JAX kernel has no replicate axis of its own (`vmap` adds a grid axis
there). Here `replicates = B` says that `x` holds B batches of the
`n_tiles` tiles one after another, `[B * n_tiles * R, 128]`; tile j of
every batch goes through tables j, in one launch that reads the offsets
once.

On a CUDA tensor `tile_permute` launches the hand-written kernel
`csrc/tile_permute.cu` (built at first use by `kernels/build.py`) or
raises; `tile_permute_reference` is the same function with
`torch.take_along_dim`, used for CPU tensors and for comparisons.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from .route_stage import (
    KERNEL_SUFFIX,
    LANES,
    Stage,
    check_operand,
    kernel_function,
    on_device,
    stage_apply_reference,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, off, off_bytes, out, n_tiles, rows, B, stream
TILE_PERMUTE_ARGS = [_P, _P, _I, _P, _I, _I, _I, _P]


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


def tile_permute_cuda(x: torch.Tensor, stage: Stage,
                      replicates: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel, once whatever the number of replicates.
    Raises on anything it does not take and on a refused launch."""
    if not x.is_cuda:
        raise ValueError("tile_permute_cuda needs a CUDA tensor")
    if x.dtype not in KERNEL_SUFFIX:
        raise TypeError(f"no tile-permute kernel for {x.dtype}")
    rows, n_tiles = stage.R_in, stage.n_chunks
    total = replicates * n_tiles
    if replicates < 1 or n_tiles * rows * LANES >= 2**31:
        raise ValueError(f"unsupported tile batch: {replicates} x {n_tiles} "
                         f"x {rows} rows")
    check_operand("x", x, x.dtype, (total * rows, LANES), stage.off.device)
    out = torch.empty_like(x)
    fn = kernel_function("tile_permute", x.dtype, TILE_PERMUTE_ARGS)
    dev = x.device
    with on_device(dev):
        err = fn(
            x.data_ptr(), stage.off.data_ptr(), stage.off.element_size(),
            out.data_ptr(), n_tiles, rows, replicates,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"tile_permute kernel launch failed: CUDA error {err}")
    trace.count("launch.tile_permute")
    return out


def tile_permute(x: torch.Tensor, stage: Stage,
                 replicates: int = 1) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return tile_permute_cuda(x, stage, replicates)
    return tile_permute_reference(x, stage.r1, stage.r2, stage.src, stage.row,
                                  stage.R_in, stage.n_chunks, replicates)
