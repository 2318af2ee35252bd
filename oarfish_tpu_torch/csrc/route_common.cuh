// Shared by tile_permute.cu, route_stage.cu and route_middle.cu: how one
// stage of a static gather network finds the source of an output element,
// and the gather through composed source offsets that K2 and K3 run.
//
// A stage maps a chunk's input tile [R_in, 128] to its output tile
// [R_out, 128] through four int8 tables (values 0..127):
//
//   r2  [n, R_out, 128]        lane of the "channel" tile that output
//                              element (ro, c) takes:  c2 = r2[ro][c]
//   src [n, R_out/128, 128, 128]   input block (absent when R_in == 128)
//   row [n, R_out/128, 128, 128]   and row in that block that feed
//                              channel c2 of output row ro, stored
//                              [block of ro][c2][ro % 128]
//   r1  [n, R_in, 128]         lane of input row ri that feeds channel c2
//
// so that out[ro][c] = in[ri][r1[ri][c2]] with
// ri = src[ro/128][c2][ro%128] * 128 + row[ro/128][c2][ro%128].
// The JAX package's kernels apply the same tables as whole-tile lane
// gathers, 128x128 transposes and an unrolled block select, because that is
// what its target can lower; a GPU thread follows the three lookups for
// its own element.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace route {

constexpr int LANES = 128;

struct StageTables {
    const int8_t* r1;   // [n, R_in, 128]
    const int8_t* src;  // [n, R_out/128, 128, 128] or nullptr (one block)
    const int8_t* row;  // [n, R_out/128, 128, 128]
    const int8_t* r2;   // [n, R_out, 128]
    int R_in;
    int R_out;
};

// Source (row ri, lane li) in chunk j's input tile for output element
// (ro, c). False when the block table names a block the input does not
// have: such an element is 0, as the block select of the JAX kernel
// leaves it.
__device__ __forceinline__ bool stage_source(const StageTables& t, int j,
                                             int ro, int c, int& ri, int& li)
{
    const int h_out = t.R_out / LANES;
    const int c2 = t.r2[((int64_t)j * t.R_out + ro) * LANES + c] & 127;
    const int64_t mid =
        (((int64_t)j * h_out + (ro >> 7)) * LANES + c2) * LANES + (ro & 127);
    const int hi = t.src ? (int)t.src[mid] : 0;
    if (hi < 0 || hi * LANES >= t.R_in) return false;
    ri = hi * LANES + (t.row[mid] & 127);
    li = t.r1[((int64_t)j * t.R_in + ri) * LANES + c2] & 127;
    return true;
}

// Offset of element (row, lane) of chunk j's [R_in, 128] input tile.
//   Q == 0  the tiles lie one after another: [n_chunks * R_in, 128].
//   Q  > 0  the values are the quota tensor [n_src, n_chunks, Q] as the
//           expand stage wrote it (source chunk major), and chunk j's tile
//           is its column [:, j, :] flattened: the exchange between the two
//           stages is this index arithmetic and no transpose.
__device__ __forceinline__ int64_t tile_offset(int j, int row, int lane,
                                               int R_in, int Q, int n_chunks)
{
    if (Q == 0) return ((int64_t)j * R_in + row) * LANES + lane;
    const int e = row * LANES + lane;
    const int s = e / Q;
    return ((int64_t)s * n_chunks + j) * Q + (e - s * Q);
}

// ---------------------------------------------------------------------------
// Composed source offsets
// ---------------------------------------------------------------------------
//
// The plan composes, once, the source of every output element of a stage
// from the tables above: e = ri * 128 + li, the element's offset inside its
// chunk's [R_in, 128] input tile, or -1 where the output is 0 (a masked
// element, or a block the input lacks). int16 where R_in * 128 <= 32768,
// int32 otherwise (ops/route_stage.py::stage_offsets). A kernel then makes
// one coalesced offset load per element where the tables cost three
// dependent scattered lookups.

constexpr int VEC = 8;  // outputs a thread moves at once

// Where chunk j's input tile lies inside one replicate of the values (see
// tile_offset). For the quota view the tile row ri = e >> 7 is split as
// s * (Q / 128) + rr with a multiply-high by q_inv = ceil(2^32 / (Q / 128)),
// exact while ri * Q / 128 < 2^32 (the wrapper checks): no division.
struct Layout {
    int R_in;       // rows of a chunk's input tile
    int n_chunks;
    int Q;          // 0: tiles one after another; > 0: the quota view
    unsigned long long q_inv;
};

// Offset of element e of chunk j's input tile inside one replicate (the
// wrapper keeps a replicate under 2^31 elements).
__device__ __forceinline__ int source_offset(const Layout& l, int j, int e)
{
    if (l.Q == 0) return j * l.R_in * LANES + e;
    const int s = (int)(((unsigned long long)(e >> 7) * l.q_inv) >> 32);
    return (s * l.n_chunks + j) * l.Q + (e - s * l.Q);
}

// VEC consecutive offsets in one or two 16-byte loads.
__device__ __forceinline__ void load_offsets(const int16_t* p, int (&o)[VEC])
{
    const int4 w = __ldg(reinterpret_cast<const int4*>(p));
    const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < VEC; ++k)
        o[k] = (k & 1) ? (words[k >> 1] >> 16)
                       : (int)(int16_t)(words[k >> 1] & 0xffff);
}

__device__ __forceinline__ void load_offsets(const int32_t* p, int (&o)[VEC])
{
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// VEC consecutive values in 16-byte stores.
__device__ __forceinline__ void store_values(float* p, const float (&v)[VEC])
{
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_values(double* p, const double (&v)[VEC])
{
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k)
        reinterpret_cast<double2*>(p)[k] =
            make_double2(v[2 * k], v[2 * k + 1]);
}

constexpr int GATHER_THREADS = 128;

// out[b, j, o] = off[j, o] < 0 ? 0 : x[b, source of off[j, o]] (* mul),
// VEC outputs a thread: one vector load of offsets, VEC independent value
// loads (and factors of `mul`, tile after tile, [n_chunks * R_in, 128]),
// a vector store. One replicate a block, the B blocks that share a range of
// offsets side by side in the grid: they run together, so the offsets cross
// device memory once and come from L2 for the other replicates. (A thread
// moving all B replicates of its offsets was slower, PERF.md section 6.)
// The tile is read through L2: nothing limits its size. The body of the
// gather kernels of tile_permute.cu and route_stage.cu, which keep their
// own names for the profiler.
template <typename T, typename Off>
__device__ __forceinline__ void gather_stage(
    const T* __restrict__ x, const T* __restrict__ mul,
    const Off* __restrict__ off, T* __restrict__ out, Layout l,
    int out_per_chunk, int B)
{
    const int b = blockIdx.x % B;
    const int64_t first =
        ((int64_t)(blockIdx.x / B) * GATHER_THREADS + threadIdx.x) * VEC;
    const int64_t out_rep = (int64_t)l.n_chunks * out_per_chunk;
    if (first >= out_rep) return;
    // out_per_chunk is a multiple of 128: a thread's outputs share a chunk
    const int j = (int)(first / out_per_chunk);
    const T* xb = x + (int64_t)b * l.n_chunks * l.R_in * LANES;
    int o[VEC];
    load_offsets(off + first, o);
    T v[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k)
        v[k] = o[k] < 0 ? T(0) : xb[source_offset(l, j, o[k])];
    if (mul != nullptr) {
        const T* mul_j = mul + (int64_t)j * l.R_in * LANES;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            if (o[k] >= 0) v[k] = v[k] * mul_j[o[k]];
    }
    store_values(out + b * out_rep + first, v);
}

template <typename T, typename Off>
using GatherKernel = void (*)(const T*, const T*, const Off*, T*, Layout, int,
                              int);

// Launch a gather kernel (k16 for int16 offsets, k32 for int32, as
// off_bytes says) over n_chunks chunks of out_per_chunk outputs and B >= 1
// replicates. Returns the launch's error.
template <typename T>
int launch_gather(GatherKernel<T, int16_t> k16, GatherKernel<T, int32_t> k32,
                  const void* x, const void* mul, const void* off,
                  int off_bytes, void* out, Layout l, int out_per_chunk,
                  int B, cudaStream_t stream)
{
    const int64_t n_out = (int64_t)l.n_chunks * out_per_chunk;
    if (n_out == 0 || B <= 0) return (int)cudaSuccess;
    if (out_per_chunk % LANES != 0) return (int)cudaErrorInvalidValue;
    const int64_t blocks =
        (n_out / VEC + GATHER_THREADS - 1) / GATHER_THREADS * B;
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    if (off_bytes == 2)
        k16<<<(unsigned)blocks, GATHER_THREADS, 0, stream>>>(
            (const T*)x, (const T*)mul, (const int16_t*)off, (T*)out, l,
            out_per_chunk, B);
    else if (off_bytes == 4)
        k32<<<(unsigned)blocks, GATHER_THREADS, 0, stream>>>(
            (const T*)x, (const T*)mul, (const int32_t*)off, (T*)out, l,
            out_per_chunk, B);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // namespace route
