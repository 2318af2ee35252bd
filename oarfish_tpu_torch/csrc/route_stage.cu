// One stage of a GlobalRoute gather network, over all chunks:
//   out[j, ro, c] = mask[j, ro, c] ? in_j[ri, li] * mul[j, ri, li] : 0
// with (ri, li) found through the stage's tables (route_common.cuh) and
// in_j chunk j's input tile, [R_in, 128] -> [R_out, 128] per chunk.
//
// Replaces the Pallas kernel of ops/static_permute.py of the JAX package
// (`_stage_apply` + `_make_route_kernel` / `_run_route_stage`). That
// kernel builds the stage from whole-tile lane gathers, 128x128 transposes
// and an H_in x H_out unrolled gather-and-select, widens the int8 tables
// before comparing, and reads the strided quota view through a 4-D block
// spec; all of that is what its target can lower. Here one thread makes
// the three dependent table lookups of one output element and loads its
// value. The optional factor `mul` is taken at the source element, before
// any gather, as the JAX kernel multiplies the input tile. The quota
// exchange between the expand and the reduce stage is index arithmetic
// (`tile_offset` with Q > 0).
//
// Replicate axis (the `B > 0` arm of `_make_route_kernel`): values and
// output carry a leading axis of B replicates, tables, mask and `mul` are
// shared. The JAX kernel loops over the replicates around the whole stage
// and so repeats every whole-tile gather B times; here the thread keeps the
// source (ri, li) and the factor in registers and moves B values, so the
// three dependent lookups are made once for all replicates and the tables
// cross device memory once a launch. An element's offset inside one
// replicate fits 32 bits (the wrapper checks); the replicate stride is
// added in 64 bits.
//
// Bound: bytes. Per output element 4 table bytes (5 with a mask) and B
// values written; per input element B values (and one factor with `mul`)
// read. No arithmetic beyond the one product. The r2 / mask reads and the
// output writes are coalesced; the src / row / r1 lookups and the value
// loads are scattered within one chunk's tables and tile (at most a few
// megabytes a replicate), which the L2 cache holds while the chunk's blocks
// run.
//
// Plain C interface for ctypes; the wrapper
// (oarfish_tpu_torch/ops/route_stage.py) allocates the output, checks
// shapes and passes the current stream. Each entry point returns
// cudaGetLastError() of its launch. Built without fused multiply-add.

#include "route_common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void route_stage_kernel(
    const T* __restrict__ x,          // B x input tiles (see tile_offset)
    const T* __restrict__ mul,        // [n_chunks * R_in, 128] or nullptr
    route::StageTables t,
    const int8_t* __restrict__ mask,  // [n_chunks, R_out, 128] or nullptr
    T* __restrict__ out,              // [B, n_chunks * R_out, 128]
    int n_chunks, int Q, int B)
{
    const int64_t per_chunk = (int64_t)t.R_out * route::LANES;
    const int64_t out_rep = per_chunk * n_chunks;  // replicate strides
    const int64_t x_rep = (int64_t)t.R_in * route::LANES * n_chunks;
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= out_rep) return;
    const int j = (int)(idx / per_chunk);
    const int rem = (int)(idx - j * per_chunk);
    int ri, li;
    if ((mask != nullptr && mask[idx] == 0) ||
        !route::stage_source(t, j, rem >> 7, rem & 127, ri, li)) {
        for (int b = 0; b < B; ++b) out[b * out_rep + idx] = T(0);
        return;
    }
    const int64_t off = route::tile_offset(j, ri, li, t.R_in, Q, n_chunks);
    if (mul != nullptr) {
        const T m = mul[((int64_t)j * t.R_in + ri) * route::LANES + li];
#pragma unroll 4
        for (int b = 0; b < B; ++b)
            out[b * out_rep + idx] = x[b * x_rep + off] * m;
    } else {
#pragma unroll 4
        for (int b = 0; b < B; ++b)
            out[b * out_rep + idx] = x[b * x_rep + off];
    }
}

template <typename T>
int launch(const void* x, const void* mul, const void* r1, const void* src,
           const void* row, const void* r2, const void* mask, void* out,
           int n_chunks, int R_in, int R_out, int Q, int B, void* stream)
{
    // threads cover one replicate's outputs; each moves B values
    const int64_t n_out = (int64_t)n_chunks * R_out * route::LANES;
    if (n_out == 0 || B <= 0) return (int)cudaSuccess;
    route::StageTables t{(const int8_t*)r1, (const int8_t*)src,
                         (const int8_t*)row, (const int8_t*)r2, R_in, R_out};
    const unsigned grid = (unsigned)((n_out + THREADS - 1) / THREADS);
    route_stage_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)mul, t, (const int8_t*)mask, (T*)out,
        n_chunks, Q, B);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int route_stage_f32(const void* x, const void* mul, const void* r1,
                    const void* src, const void* row, const void* r2,
                    const void* mask, void* out, int n_chunks, int R_in,
                    int R_out, int Q, int B, void* stream)
{
    return launch<float>(x, mul, r1, src, row, r2, mask, out, n_chunks, R_in,
                         R_out, Q, B, stream);
}

int route_stage_f64(const void* x, const void* mul, const void* r1,
                    const void* src, const void* row, const void* r2,
                    const void* mask, void* out, int n_chunks, int R_in,
                    int R_out, int Q, int B, void* stream)
{
    return launch<double>(x, mul, r1, src, row, r2, mask, out, n_chunks, R_in,
                          R_out, Q, B, stream);
}

}  // extern "C"
