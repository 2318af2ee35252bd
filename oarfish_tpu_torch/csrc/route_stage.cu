// One stage of a GlobalRoute gather network, over all chunks:
//   out[j, ro, c] = in_j[e] * mul_j[e]   where e = off[j, ro, c] >= 0,
//   out[j, ro, c] = 0                    where off[j, ro, c] = -1,
// with in_j chunk j's input tile [R_in, 128] and `off` the source offsets
// the plan composed from the stage's int8 tables (route_common.cuh), mask
// and missing blocks folded in as -1. [R_in, 128] -> [R_out, 128] per chunk.
//
// Replaces the Pallas kernel of ops/static_permute.py of the JAX package
// (`_stage_apply` + `_make_route_kernel` / `_run_route_stage`). That
// kernel builds the stage from whole-tile lane gathers, 128x128 transposes
// and an H_in x H_out unrolled gather-and-select, widens the int8 tables
// before comparing, and reads the strided quota view through a 4-D block
// spec; all of that is what its target can lower. The optional factor `mul`
// is taken at the source element, before any gather, as the JAX kernel
// multiplies the input tile. The quota exchange between the expand and the
// reduce stage is index arithmetic (`source_offset` with Q > 0).
//
// Two variants, chosen by the wrapper (oarfish_tpu_torch/ops/route_stage.py,
// `stage_variant`) from the dtype, R_in and the operands' alignment:
//
//   shared  where chunk j's input tile fits a block's shared memory (227 KB:
//           128 and 256 rows in f32, 128 in f64) and the offsets are int16.
//           One block per chunk stages the tile with 16-byte loads, applying
//           `mul` on the way (both streams coalesced), then reads the offsets
//           8 a thread in one 16-byte load, gathers from shared memory and
//           writes 16-byte stores. Device memory sees each input, factor,
//           offset and output once.
//   gather  everywhere else (the reduce stage, 512 rows in f32, f64 stages):
//           route::gather_stage, 8 outputs a thread with their values
//           loaded through L2, where the blocks of a chunk, which run
//           together, keep its tile. Each value is a 32-byte sector out of
//           L2: the sector rate, not device memory, bounds this variant.
//
// Replicate axis (the `B > 0` arm of `_make_route_kernel`): values and
// output carry a leading axis of B replicates; offsets and `mul` are
// shared. The JAX kernel loops over the replicates around the whole stage
// and so repeats every whole-tile gather B times. Here the shared variant
// gives each replicate of a chunk its own block, the B blocks of a chunk
// side by side in the grid so that they run together and the chunk's
// offsets and `mul` cross device memory once; the gather variant does the
// same with its blocks of 1,024 outputs. An element's offset inside one
// replicate fits 32 bits (the wrapper checks); the replicate stride is
// added in 64 bits.
//
// Bound: bytes. Per output element 2 or 4 offset bytes and B values
// written; per input element B values (and one factor with `mul`) read. No
// arithmetic beyond the one product.
//
// Plain C interface for ctypes; the wrapper allocates the output, checks
// the values and passes the current stream (the offsets were checked where
// the plan was built). Each entry point returns cudaGetLastError() of its
// launch. Built without fused multiply-add.

#include "route_common.cuh"

namespace {

constexpr int THREADS = 512;    // shared variant: one block per chunk
constexpr int STAGE_BATCH = 2;   // 16-byte loads of x (and of mul) in flight
constexpr int GATHER_BATCH = 2;  // offset vectors a thread has in flight
constexpr size_t SMEM_LIMIT = 227 * 1024;  // opt-in maximum of a block

template <typename T> struct Vec16;
template <> struct Vec16<float> {
    using type = float4;
    __device__ static float4 mul(float4 a, float4 b)
    {
        return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
    }
};
template <> struct Vec16<double> {
    using type = double2;
    __device__ static double2 mul(double2 a, double2 b)
    {
        return make_double2(a.x * b.x, a.y * b.y);
    }
};

// One block per chunk and replicate, the B replicates of a chunk next to
// each other in the grid: they run together, so the chunk's offsets and
// `mul` come from device memory once and from L2 for the others. (The
// first version looped over the replicates inside the block and took about
// twice the time, PERF.md section 6.)
// The launch checks that both loops divide evenly: R_in and R_out are
// multiples of 128, so n_in / V and out_per_chunk / VEC are multiples of
// THREADS * STAGE_BATCH and THREADS * GATHER_BATCH.
template <typename T>
__global__ void __launch_bounds__(THREADS) route_stage_shared_kernel(
    const T* __restrict__ x,          // B x input tiles (route::source_offset)
    const T* __restrict__ mul,        // [n_chunks * R_in, 128] or nullptr
    const int16_t* __restrict__ off,  // [n_chunks, R_out, 128]
    T* __restrict__ out,              // [B, n_chunks * R_out, 128]
    route::Layout l, int out_per_chunk, int B)
{
    using Vec = typename Vec16<T>::type;
    constexpr int V = 16 / sizeof(T);
    extern __shared__ __align__(16) unsigned char smem[];
    T* tile = reinterpret_cast<T*>(smem);
    const int j = blockIdx.x / B;
    const int b = blockIdx.x - j * B;
    const int n_in = l.R_in * route::LANES;
    const T* xb = x + (int64_t)b * l.n_chunks * n_in;
    const T* mul_j = mul == nullptr ? nullptr : mul + (int64_t)j * n_in;
    // stage: V consecutive elements of one 128-lane row per load, which lie
    // together in either layout; `mul` applied on the way
    for (int e0 = threadIdx.x * V; e0 < n_in;
         e0 += THREADS * V * STAGE_BATCH) {
        Vec v[STAGE_BATCH];
#pragma unroll
        for (int k = 0; k < STAGE_BATCH; ++k)
            v[k] = *reinterpret_cast<const Vec*>(
                xb + route::source_offset(l, j, e0 + k * THREADS * V));
        if (mul_j != nullptr) {
#pragma unroll
            for (int k = 0; k < STAGE_BATCH; ++k)
                v[k] = Vec16<T>::mul(v[k], *reinterpret_cast<const Vec*>(
                                               mul_j + e0 + k * THREADS * V));
        }
#pragma unroll
        for (int k = 0; k < STAGE_BATCH; ++k)
            *reinterpret_cast<Vec*>(tile + e0 + k * THREADS * V) = v[k];
    }
    __syncthreads();
    // gather: 8 offsets in one 16-byte load, 8 values out of shared memory,
    // 16-byte stores
    const int16_t* off_j = off + (int64_t)j * out_per_chunk;
    T* out_j = out + ((int64_t)b * l.n_chunks + j) * out_per_chunk;
    for (int g0 = threadIdx.x * route::VEC; g0 < out_per_chunk;
         g0 += THREADS * route::VEC * GATHER_BATCH) {
        int o[GATHER_BATCH][route::VEC];
#pragma unroll
        for (int k = 0; k < GATHER_BATCH; ++k)
            route::load_offsets(off_j + g0 + k * THREADS * route::VEC, o[k]);
#pragma unroll
        for (int k = 0; k < GATHER_BATCH; ++k) {
            T v[route::VEC];
#pragma unroll
            for (int i = 0; i < route::VEC; ++i)
                v[i] = o[k][i] < 0 ? T(0) : tile[o[k][i]];
            route::store_values(out_j + g0 + k * THREADS * route::VEC, v);
        }
    }
}

template <typename T, typename Off>
__global__ void __launch_bounds__(route::GATHER_THREADS)
route_stage_gather_kernel(const T* __restrict__ x, const T* __restrict__ mul,
                          const Off* __restrict__ off, T* __restrict__ out,
                          route::Layout l, int out_per_chunk, int B)
{
    route::gather_stage(x, mul, off, out, l, out_per_chunk, B);
}

template <typename T>
int launch(const void* x, const void* mul, const void* off, int off_bytes,
           int shared, void* out, int n_chunks, int R_in, int R_out, int Q,
           unsigned long long q_inv, int B, void* stream)
{
    const route::Layout l{R_in, n_chunks, Q, q_inv};
    const int out_per_chunk = R_out * route::LANES;
    if (!shared)
        return route::launch_gather<T>(
            route_stage_gather_kernel<T, int16_t>,
            route_stage_gather_kernel<T, int32_t>, x, mul, off, off_bytes,
            out, l, out_per_chunk, B, (cudaStream_t)stream);
    if (n_chunks == 0 || B <= 0) return (int)cudaSuccess;
    if ((int64_t)n_chunks * B >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    constexpr int V = 16 / sizeof(T);
    const size_t bytes = (size_t)R_in * route::LANES * sizeof(T);
    if (off_bytes != 2 || bytes > SMEM_LIMIT ||
        (R_in * route::LANES / V) % (THREADS * STAGE_BATCH) != 0 ||
        (out_per_chunk / route::VEC) % (THREADS * GATHER_BATCH) != 0)
        return (int)cudaErrorInvalidValue;
    const cudaError_t attr = cudaFuncSetAttribute(
        route_stage_shared_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (attr != cudaSuccess) return (int)attr;
    route_stage_shared_kernel<T><<<(unsigned)n_chunks * B, THREADS, bytes,
                                   (cudaStream_t)stream>>>(
        (const T*)x, (const T*)mul, (const int16_t*)off, (T*)out, l,
        out_per_chunk, B);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// off_bytes: 2 (int16 offsets) or 4 (int32); shared: 1 for the shared
// variant, 0 for the gather; Q: 0 for tile-after-tile values, the quota for
// the quota view, with q_inv = ceil(2^32 / (Q / 128)); B >= 1 replicates.
int route_stage_f32(const void* x, const void* mul, const void* off,
                    int off_bytes, int shared, void* out, int n_chunks,
                    int R_in, int R_out, int Q, unsigned long long q_inv,
                    int B, void* stream)
{
    return launch<float>(x, mul, off, off_bytes, shared, out, n_chunks, R_in,
                         R_out, Q, q_inv, B, stream);
}

int route_stage_f64(const void* x, const void* mul, const void* off,
                    int off_bytes, int shared, void* out, int n_chunks,
                    int R_in, int R_out, int Q, unsigned long long q_inv,
                    int B, void* stream)
{
    return launch<double>(x, mul, off, off_bytes, shared, out, n_chunks,
                          R_in, R_out, Q, q_inv, B, stream);
}

}  // extern "C"
