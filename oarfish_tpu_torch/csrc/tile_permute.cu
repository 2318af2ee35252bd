// Batched static tile permutation:
//   out[b, t, r, c] = x[b, t, e]   with e = off[t, r, c],
// the source offset inside tile t that the plan composed from the
// three-stage decomposition's int8 tables (route_common.cuh):
//   e = ri * 128 + r1[t, ri, c2],   c2 = r2[t, r, c],
//   ri = src[t, r/128, c2, r%128] * 128 + lane[t, r/128, c2, r%128].
//
// Replaces the Pallas kernel of ops/static_permute.py of the JAX package
// (`_make_kernel` / `_run_batch`, wrapped by `BatchTilePermute`). That
// kernel applies a fixed permutation of a [R, 128] tile as a lane gather,
// a column stage run blockwise in transposed space (H x H unrolled
// gather-and-select over 128x128 blocks) and a second lane gather, because
// its target has no per-element gather. Here the permutation is one int32
// (int16 for tiles of at most 256 rows) offset per element, composed once
// when the plan is built, and the kernel runs route::gather_stage:
// 8 outputs a thread, one 16-byte offset load, 8 independent value loads, a
// vector store.
//
// The JAX kernel has no replicate axis (`vmap` adds a grid axis there).
// Here a batch of B replicates, x [B * n_tiles * R, 128], is one launch
// whose blocks of a range of offsets, one per replicate, run side by side:
// the offsets cross device memory once.
//
// Bound: bytes. Per element one offset (read once for all replicates) and
// B values read and written. The tiles of the EM (one tile of some thousand
// rows, under a megabyte) sit in L2, so the scattered value loads are
// served from it, one 32-byte sector each: a single launch is about as
// short as a launch can be, a batch is bound by L2's sector rate.
//
// Plain C interface for ctypes; the wrapper
// (oarfish_tpu_torch/ops/tile_permute.py) allocates the output, checks the
// values and passes the current stream. Each entry point returns
// cudaGetLastError() of its launch.

#include "route_common.cuh"

namespace {

template <typename T, typename Off>
__global__ void __launch_bounds__(route::GATHER_THREADS) tile_permute_kernel(
    const T* __restrict__ x, const T* __restrict__ mul,
    const Off* __restrict__ off, T* __restrict__ out, route::Layout l,
    int out_per_chunk, int B)
{
    route::gather_stage(x, mul, off, out, l, out_per_chunk, B);
}

template <typename T>
int launch(const void* x, const void* off, int off_bytes, void* out,
           int n_tiles, int rows, int B, void* stream)
{
    const route::Layout l{rows, n_tiles, 0, 0};
    return route::launch_gather<T>(
        tile_permute_kernel<T, int16_t>, tile_permute_kernel<T, int32_t>, x,
        nullptr, off, off_bytes, out, l, rows * route::LANES, B,
        (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// off: [n_tiles, rows, 128] of off_bytes (2 or 4) each; B >= 1 replicates
int tile_permute_f32(const void* x, const void* off, int off_bytes, void* out,
                     int n_tiles, int rows, int B, void* stream)
{
    return launch<float>(x, off, off_bytes, out, n_tiles, rows, B, stream);
}

int tile_permute_f64(const void* x, const void* off, int off_bytes, void* out,
                     int n_tiles, int rows, int B, void* stream)
{
    return launch<double>(x, off, off_bytes, out, n_tiles, rows, B, stream);
}

}  // extern "C"
