"""One stage of a `GlobalRoute` gather network over all chunks.

Counterpart of `_stage_apply` / `_run_route_stage` in the JAX package's
`ops/static_permute.py`. Per chunk j the stage maps an input tile
`[R_in, 128]` to an output tile `[R_out, 128]` through four int8 tables:

    c2 = r2[j, ro, c]
    ri = src[j, ro // 128, c2, ro % 128] * 128 + row[j, ro // 128, c2, ro % 128]
    out[j, ro, c] = x_j[ri, r1[j, ri, c2]] * mul_j[ri, r1[j, ri, c2]]

(`src` is absent when the input is one block of 128 rows; `mul` is
optional and taken at the source element), and 0 where `mask[j, ro, c]`
is 0. The values come either as `[n_chunks * R_in, 128]`, tile after tile,
or as the 4-D view `[n_src, n_chunks, Q/128, 128]` of the quota tensor
that the expand stage wrote: chunk j's tile is then `x[:, j]` flattened,
and the exchange between the two stages needs no transpose.

A `Stage` holds the tables of one stage, checked once, and the source
offsets composed from them once (`stage_offsets`): per output element
`ri * 128 + li` inside its chunk's input tile, or -1 where the output is
0. The kernel reads those offsets; the plain version reads the tables.

Replicate axis (the `B > 0` arm of the JAX kernel): values of either
layout may carry a leading axis of B replicates, `[B, n_chunks * R_in, 128]`
or `[B, n_src, n_chunks, Q/128, 128]`, and the output is then
`[B, n_chunks * R_out, 128]`; offsets, mask and `mul` are shared. Replicate
b comes out exactly as a call without the axis gives it for `x[b]`, in one
launch that reads the offsets once.

On a CUDA tensor `route_stage` launches the hand-written kernel
`csrc/route_stage.cu` (built at first use by `kernels/build.py`) in the
variant `stage_variant` picks, or raises; `route_stage_reference` is the
same function with `torch.take_along_dim`, used for CPU tensors and for
comparisons.
"""

from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from ..kernels import build
from ..utils import trace

LANES = 128

KERNEL_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# bytes of shared memory a block may take on this card (opt-in maximum)
SHARED_LIMIT = 227 * 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, mul, off, off_bytes, shared, out, n_chunks, R_in, R_out, Q, q_inv, B,
# stream
ROUTE_STAGE_ARGS = [_P, _P, _P, _I, _I, _P, _I, _I, _I, _I, ctypes.c_uint64,
                    _I, _P]


def check_operand(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous tensor of that dtype and shape on
    that device."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the values on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_stage_tables(tag, r1, src, row, r2, n, R_in, R_out, device) -> None:
    i8 = torch.int8
    H_out = R_out // LANES
    check_operand(f"{tag}r1", r1, i8, (n, R_in, LANES), device)
    if R_in > LANES:
        if src is None:
            raise ValueError(f"{tag}src is needed for R_in = {R_in} > {LANES}")
        check_operand(f"{tag}src", src, i8, (n, H_out, LANES, LANES), device)
    check_operand(f"{tag}row", row, i8, (n, H_out, LANES, LANES), device)
    check_operand(f"{tag}r2", r2, i8, (n, R_out, LANES), device)


_entry_points: Dict[Tuple[str, torch.dtype], ctypes._CFuncPtr] = {}


def kernel_function(library: str, dtype: torch.dtype, argtypes):
    """The `<library>_f32` / `_f64` entry point of `csrc/<library>.cu`,
    built and given its ctypes signature at first use, then kept."""
    fn = _entry_points.get((library, dtype))
    if fn is None:
        fn = getattr(build.cuda_library(library),
                     f"{library}_{KERNEL_SUFFIX[dtype]}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entry_points[(library, dtype)] = fn
    return fn


def on_device(dev: torch.device):
    """`torch.cuda.device(dev)`, or nothing where `dev` is current."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def input_tiles(x: torch.Tensor, n_chunks: int, R_in: int) -> torch.Tensor:
    """`[n_chunks, R_in, 128]` tiles of either value layout, behind the
    replicate axis where the values have one."""
    lead = x.shape[:1] if x.dim() in (3, 5) else ()
    if x.dim() >= 4:
        x = x.transpose(-4, -3)
    return x.reshape(*lead, n_chunks, R_in, LANES)


def stage_apply_reference(
    tiles: torch.Tensor, r1: torch.Tensor, src: Optional[torch.Tensor],
    row: torch.Tensor, r2: torch.Tensor, mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """The stage on `[..., n, R_in, 128]` tiles -> `[..., n, R_out, 128]`:
    lane gather by `r1`, row gather per lane by `src * 128 + row`, lane
    gather by `r2`, zero mask. The tables `[n, ...]` serve every leading
    axis."""
    n, R_in = tiles.shape[-3], tiles.shape[-2]
    R_out = r2.shape[1]
    lead = tiles.shape[:-3]

    def gather(x, t, dim):  # the tables `[n, ...]` serve every leading axis
        return torch.gather(x, dim, t.expand(*lead, *t.shape))

    s1 = gather(tiles, r1.long(), -1)
    ri = row.long()
    if src is not None and R_in > LANES:
        blk = src.long()
        known = (blk >= 0) & (blk < R_in // LANES)
        ri = ri + blk.clamp(0, R_in // LANES - 1) * LANES
    else:
        known = None
    # tables are stored [block of ro][c2][ro % 128]
    ri = ri.permute(0, 1, 3, 2).reshape(n, R_out, LANES)
    q = gather(s1, ri, -2)
    if known is not None:
        q = torch.where(known.permute(0, 1, 3, 2).reshape(n, R_out, LANES),
                        q, torch.zeros_like(q))
    out = gather(q, r2.long(), -1)
    if mask is not None:
        out = torch.where(mask != 0, out, torch.zeros_like(out))
    return out


def route_stage_reference(
    x: torch.Tensor, r1: torch.Tensor, src: Optional[torch.Tensor],
    row: torch.Tensor, r2: torch.Tensor, mask: Optional[torch.Tensor],
    n_chunks: int, R_in: int, R_out: int,
    mul: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain torch version of the kernel: `[n_chunks * R_out, 128]`,
    behind the replicate axis where the values have one."""
    tiles = input_tiles(x, n_chunks, R_in)
    if mul is not None:
        tiles = tiles * mul.reshape(n_chunks, R_in, LANES)
    out = stage_apply_reference(tiles, r1, src, row, r2, mask)
    return out.reshape(*tiles.shape[:-3], n_chunks * R_out, LANES)


def offset_dtype(R_in: int) -> torch.dtype:
    """int16 where every offset inside an `[R_in, 128]` tile and -1 fit it,
    else int32."""
    return torch.int16 if R_in * LANES <= 2**15 else torch.int32


def stage_offsets(r1, src, row, r2, mask, R_in: int) -> torch.Tensor:
    """The source of every output element, `[n, R_out, 128]`: its offset
    `ri * 128 + li` inside its chunk's `[R_in, 128]` input tile, or -1
    where the stage gives 0 (masked, or a block the input lacks). Made by
    the plain version on an integer iota, on the tables' device; its type
    is `offset_dtype(R_in)`."""
    n = r1.shape[0]
    iota = torch.arange(1, R_in * LANES + 1, dtype=torch.int32,
                        device=r1.device).reshape(1, R_in, LANES)
    off = stage_apply_reference(iota.expand(n, R_in, LANES), r1, src, row,
                                r2, mask) - 1
    return off.to(offset_dtype(R_in)).contiguous()


@dataclass(frozen=True)
class Stage:
    """One stage over `n_chunks` chunks, `[R_in, 128] -> [R_out, 128]`
    each: its int8 tables, checked here, and the source offsets composed
    from them here (`stage_offsets`), once. The wrappers then check only
    the values of a call."""

    r1: torch.Tensor  # [n, R_in, 128] i8
    src: Optional[torch.Tensor]  # [n, R_out/128, 128, 128] i8 (R_in > 128)
    row: torch.Tensor  # [n, R_out/128, 128, 128] i8
    r2: torch.Tensor  # [n, R_out, 128] i8
    mask: Optional[torch.Tensor]  # [n, R_out, 128] i8 or None
    n_chunks: int
    R_in: int
    R_out: int
    off: torch.Tensor = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        dev = self.r1.device
        if self.R_in % LANES or self.R_out % LANES:
            raise ValueError(f"a stage of {self.R_in} -> {self.R_out} rows: "
                             f"both must be multiples of {LANES}")
        check_stage_tables("", self.r1, self.src, self.row, self.r2,
                           self.n_chunks, self.R_in, self.R_out, dev)
        if self.mask is not None:
            check_operand("mask", self.mask, torch.int8,
                          (self.n_chunks, self.R_out, LANES), dev)
        object.__setattr__(self, "off", stage_offsets(
            self.r1, self.src, self.row, self.r2, self.mask, self.R_in))

    def reference(self, x: torch.Tensor,
                  mul: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`route_stage_reference` on this stage's tables."""
        return route_stage_reference(
            x, self.r1, self.src, self.row, self.r2, self.mask,
            self.n_chunks, self.R_in, self.R_out, mul=mul)


def stage_variant(dtype: torch.dtype, R_in: int, aligned: bool = True) -> str:
    """Which variant of `csrc/route_stage.cu` takes a stage: "shared" where
    a chunk's input tile fits a block's shared memory and its offsets are
    int16 (128 and 256 rows in f32, 128 in f64) and the values and `mul`
    start on 16 bytes, else "gather" (through L2)."""
    tile_bytes = R_in * LANES * dtype.itemsize
    if aligned and tile_bytes <= SHARED_LIMIT and offset_dtype(R_in) == torch.int16:
        return "shared"
    return "gather"


def q_inverse(Q: int) -> int:
    """`ceil(2^32 / (Q / 128))`: the kernel's multiply-high splits a tile
    row of the quota view into source chunk and row without a division
    (0 for tile-after-tile values)."""
    return 0 if Q == 0 else -(-(1 << 32) // (Q // LANES))


def check_values(x: torch.Tensor, n_chunks: int,
                 R_in: int) -> Tuple[int, int]:
    """Checks the value operand of a stage kernel; returns (B, Q): B is 0
    without a replicate axis and the number of replicates with one, Q is 0
    for tile-after-tile values and the quota for the quota view."""
    if not x.is_cuda:
        raise ValueError("the kernel needs a CUDA tensor")
    if x.dtype not in KERNEL_SUFFIX:
        raise TypeError(f"no kernel for {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("values must be contiguous")
    # per replicate: the kernel adds the replicate stride in 64 bits; the
    # quota view's multiply-high is exact for tiles under 2^16 rows
    if n_chunks * max(R_in, 1) * LANES >= 2**31 or R_in >= 2**16:
        raise ValueError("a stage of 2^31 elements or more is not supported")
    B = int(x.shape[0]) if x.dim() in (3, 5) else 0
    if x.dim() in (3, 5) and B < 1:
        raise ValueError("a replicate axis needs at least one replicate")
    shape = tuple(x.shape[1:] if B else x.shape)
    if len(shape) == 2:
        if shape != (n_chunks * R_in, LANES):
            raise ValueError(
                f"values must be [{n_chunks * R_in}, {LANES}] (behind a "
                f"replicate axis or not), got {tuple(x.shape)}")
        return B, 0
    if (len(shape) != 4 or shape[1] != n_chunks or shape[3] != LANES
            or shape[0] * shape[2] != R_in):
        raise ValueError(
            f"values must be [n_src, {n_chunks}, Q/128, {LANES}] with "
            f"n_src * Q/128 = {R_in} (behind a replicate axis or not), got "
            f"{tuple(x.shape)}")
    return B, int(shape[2]) * LANES


def route_stage_cuda(x: torch.Tensor, stage: Stage,
                     mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel, once whatever the number of replicates.
    Raises on anything it does not take and on a refused launch."""
    n, R_in, R_out = stage.n_chunks, stage.R_in, stage.R_out
    B, Q = check_values(x, n, R_in)
    dev = x.device
    if stage.off.device != dev:
        raise ValueError(f"the stage is on {stage.off.device}, the values "
                         f"on {dev}")
    if mul is not None:
        if Q:
            raise ValueError("mul goes with tile-after-tile values only")
        check_operand("mul", mul, x.dtype, (n * R_in, LANES), dev)
    out = torch.empty((*x.shape[:1 if B else 0], n * R_out, LANES),
                      dtype=x.dtype, device=dev)
    aligned = x.data_ptr() % 16 == 0 and (mul is None
                                          or mul.data_ptr() % 16 == 0)
    variant = stage_variant(x.dtype, R_in, aligned)
    fn = kernel_function("route_stage", x.dtype, ROUTE_STAGE_ARGS)
    with on_device(dev):
        err = fn(
            x.data_ptr(), ptr(mul), stage.off.data_ptr(),
            stage.off.element_size(), int(variant == "shared"),
            out.data_ptr(), n, R_in,
            R_out, Q, q_inverse(Q), max(B, 1),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"route_stage kernel launch failed: CUDA error {err}")
    trace.count("launch.route_stage")
    trace.count(f"launch.route_stage.{variant}")
    if B:
        trace.count("launch.route_stage.replicate")
    return out


def route_stage(x: torch.Tensor, stage: Stage,
                mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel for CUDA values, the plain version for CPU values."""
    if x.is_cuda:
        return route_stage_cuda(x, stage, mul=mul)
    return stage.reference(x, mul=mul)
