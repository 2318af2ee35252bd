// Batched static tile permutation:
//   out[t, r, c] = x[t, ri, r1[t, ri, c2]],   c2 = r2[t, r, c],
//   ri = src[t, r/128, c2, r%128] * 128 + lane[t, r/128, c2, r%128]
//
// Replaces the Pallas kernel of ops/static_permute.py of the JAX package
// (`_make_kernel` / `_run_batch`, wrapped by `BatchTilePermute`). That
// kernel applies a fixed permutation of a [R, 128] tile as a lane gather,
// a column stage run blockwise in transposed space (H x H unrolled
// gather-and-select over 128x128 blocks) and a second lane gather, because
// its target has no per-element gather. Here each thread follows the three
// table lookups for one output element and loads the value.
//
// The JAX kernel has no replicate axis (`vmap` adds a grid axis there). A
// batch of B replicates is B * n_tables tiles here, tile j taking the tables
// of tile j % n_tables: one launch for all replicates.
//
// Bound: bytes. Per element the kernel reads 4 table bytes (r1, r2, src,
// lane) and one value and writes one value; there is no arithmetic. The
// tiles of the EM (one tile of some thousand rows) fit the L2 cache, so
// the dependent, scattered table reads are served from it; the r2 read and
// the output write are coalesced.
//
// Plain C interface for ctypes; the wrapper
// (oarfish_tpu_torch/ops/tile_permute.py) allocates the output, checks
// shapes and passes the current stream. Each entry point returns
// cudaGetLastError() of its launch.

#include "route_common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void tile_permute_kernel(
    const T* __restrict__ x,  // [n_tiles * R, 128]
    route::StageTables t,     // r1, r2 [n_tables, R, 128]; src, row = lane
                              // [n_tables, R/128, 128, 128]
    T* __restrict__ out,      // [n_tiles * R, 128]
    int64_t n_out,            // n_tiles * R * 128
    int n_tables)             // n_tiles is a multiple of it
{
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n_out) return;
    const int64_t per_tile = (int64_t)t.R_out * route::LANES;
    const int j = (int)(idx / per_tile);
    const int rem = (int)(idx - j * per_tile);
    int ri, li;
    T v = T(0);
    if (route::stage_source(t, j % n_tables, rem >> 7, rem & 127, ri, li))
        v = x[((int64_t)j * t.R_in + ri) * route::LANES + li];
    out[idx] = v;
}

template <typename T>
int launch(const void* x, const void* r1, const void* r2, const void* src,
           const void* lane, void* out, int n_tiles, int rows, int n_tables,
           void* stream)
{
    const int64_t n_out = (int64_t)n_tiles * rows * route::LANES;
    if (n_out == 0 || n_tables <= 0) return (int)cudaSuccess;
    route::StageTables t{(const int8_t*)r1, (const int8_t*)src,
                         (const int8_t*)lane, (const int8_t*)r2, rows, rows};
    const unsigned grid = (unsigned)((n_out + THREADS - 1) / THREADS);
    tile_permute_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, t, (T*)out, n_out, n_tables);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tile_permute_f32(const void* x, const void* r1, const void* r2,
                     const void* src, const void* lane, void* out,
                     int n_tiles, int rows, int n_tables, void* stream)
{
    return launch<float>(x, r1, r2, src, lane, out, n_tiles, rows, n_tables,
                     stream);
}

int tile_permute_f64(const void* x, const void* r1, const void* r2,
                     const void* src, const void* lane, void* out,
                     int n_tiles, int rows, int n_tables, void* stream)
{
    return launch<double>(x, r1, r2, src, lane, out, n_tiles, rows, n_tables,
                      stream);
}

}  // extern "C"
