// Fused EM middle, one block per read chunk j:
//   1. x  = route A's reduce stage on chunk j's quota tile [R_q, 128]
//           -> chunk space [R_c, 128], uncovered slots exactly 0 (mask);
//   2. per-read denominators: every read owns K consecutive rows at one
//      lane, K = 2^lvl a power of two, the group K-aligned; its denominator
//      is the balanced pairwise sum of the group, level s adding the
//      partner at row XOR 2^(s-1); scale = denom > thresh ? 1/denom : 0
//      (0 for rows with lvl < 0 or lvl > max_lvl); xs = x * scale (* mult);
//   3. out = route B's expand stage on xs -> quota tile [R_q, 128].
//
// Replaces the Pallas kernel of ops/static_permute.py of the JAX package
// (`_make_middle_kernel` / `_run_middle_stage`). That kernel keeps a whole
// chunk in its large on-chip memory and computes the denominators with a
// butterfly of sublane rolls over the full tile, every row at every level,
// selecting each row's level afterwards. Here the chunk lives in the
// block's shared memory where it fits (at most 227 KB a block on this
// card: chunks of 128 and 256 rows in f32, 128 rows in f64) and in a
// per-chunk scratch area in device memory otherwise; both are reached
// through one pointer, and phase 3 may read any element of the scaled
// chunk, so a block-wide barrier (with a fence for the device-memory
// case) separates the phases. The denominator of a group is summed once,
// by the thread of its first row, in exactly the butterfly's order (a
// stack of partial sums, one per level, gives the same balanced tree), and
// that thread scales the group's K elements. This relies on the layout's
// invariant that `lvl` is constant over each aligned group of 2^lvl rows
// (em_v4._read_lvl_ids writes it so).
//
// Replicate axis (the `B > 0` arm of `_make_middle_kernel`): values,
// `mult` and output carry a leading axis of B replicates; both routes'
// tables, the mask and `lvl` are shared. The JAX kernel loops over the
// replicates around the whole body and repeats every table gather B
// times. Here (`route_middle_replicates_kernel`) the block of a chunk first
// follows the lookups of both stages once and keeps each element's source
// as a 32-bit offset in a scratch area in device memory (`sources`, one
// row per chunk; a thread reads back only what it wrote, coalesced), then
// loops over the replicates, re-using its chunk buffer with a barrier
// between them: per replicate a phase is one offset, one value load and
// one store per element, 8 elements a thread at once so that its loads
// overlap. The tables cross device memory once a launch.
// Each replicate is computed exactly as a launch without the axis
// computes it.
//
// Bound: bytes. Per chunk (and replicate) the quota tile is read and
// written once, with 4 table bytes per quota element out, 5 table bytes
// and the level byte per chunk element, and `mult` where given; the sums
// are one add per chunk element. What the time follows in practice is the
// latency of the dependent loads: one block of 32 warps per chunk, each
// thread walking a chain of three scattered byte lookups and a value load
// per element. The replicate arm walks that chain once for all replicates
// and then has 8 independent loads a thread in flight.
//
// Built without fused multiply-add and without fast-math: the kernel is
// held bit for bit against its plain version. Plain C interface for
// ctypes; the wrapper (oarfish_tpu_torch/ops/route_middle.py) allocates
// output and scratch, checks shapes and passes the current stream. Each
// entry point returns the first CUDA error of its launch.

#include "route_common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int BANDS = THREADS / route::LANES;  // warps of one lane range
constexpr int UNROLL = 8;                     // elements a thread moves at once
constexpr int MAX_LEVELS = 12;                // groups of at most 2048 rows
constexpr size_t SMEM_LIMIT = 227 * 1024;     // opt-in maximum of a block

// Phase 2 on the chunk in `buf`: denominators and scaling, in place.
// `lvl` and `mult` (or nullptr) point at this chunk's rows. A thread keeps
// one lane and walks a band of R_c / 8 consecutive rows: the heads of the
// large groups (rows that are multiples of K) are then spread over the
// bands, where rows dealt out 8 apart would give every head of a group of
// 8 and more rows to the same band.
template <typename T>
__device__ __forceinline__ void scale_chunk(
    T* buf, const int8_t* __restrict__ lvl, const T* __restrict__ mult,
    int R_c, int max_lvl, T thresh)
{
    const int c = threadIdx.x & (route::LANES - 1);
    const int band_rows = R_c / BANDS;  // R_c is a multiple of 128
    const int r0 = (threadIdx.x / route::LANES) * band_rows;
    for (int r = r0; r < r0 + band_rows; ++r) {
        const int e = r * route::LANES + c;
        const int L = lvl[e];
        if (L < 0 || L > max_lvl || L >= MAX_LEVELS) {
            T xs = buf[e] * T(0);
            if (mult != nullptr) xs = xs * mult[e];
            buf[e] = xs;
            continue;
        }
        const int K = 1 << L;
        if ((r & (K - 1)) != 0 || r + K > R_c) continue;  // not a group head
        T part[MAX_LEVELS + 1];
        for (int i = 0; i < K; ++i) {
            T v = buf[(r + i) * route::LANES + c];
            int s = 0;
            for (int bits = i; bits & 1; bits >>= 1) v = part[s++] + v;
            part[s] = v;
        }
        const T denom = part[L];
        const T scale = denom > thresh ? T(1) / denom : T(0);
        for (int i = 0; i < K; ++i) {
            const int at = (r + i) * route::LANES + c;
            T xs = buf[at] * scale;
            if (mult != nullptr) xs = xs * mult[at];
            buf[at] = xs;
        }
    }
}

// The phases may read what any thread of the block wrote, in shared or in
// device memory.
__device__ __forceinline__ void block_barrier()
{
    __threadfence_block();
    __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) route_middle_kernel(
    const T* __restrict__ y,             // quota values (see tile_offset)
    const int8_t* __restrict__ lvl,      // [n_chunks * R_c, 128]
    route::StageTables a,                // route A reduce: R_q -> R_c
    const int8_t* __restrict__ a_mask,   // [n_chunks, R_c, 128]
    route::StageTables b,                // route B expand: R_c -> R_q
    const T* __restrict__ mult,          // [n_chunks * R_c, 128] or nullptr
    T* __restrict__ out,                 // [n_chunks * R_q, 128]
    T* scratch,                          // [n_chunks * R_c, 128] or nullptr
    int n_chunks, int Q, int max_lvl, T thresh)
{
    extern __shared__ __align__(16) unsigned char shared_raw[];
    const int j = blockIdx.x;
    const int R_q = a.R_in, R_c = a.R_out;
    const int n_c = R_c * route::LANES, n_q = R_q * route::LANES;
    const int64_t c_base = (int64_t)j * n_c;
    T* buf = scratch != nullptr ? scratch + c_base
                                : reinterpret_cast<T*>(shared_raw);

    // 1. route A's reduce stage into the chunk buffer
    for (int e = threadIdx.x; e < n_c; e += THREADS) {
        T v = T(0);
        int ri, li;
        if (a_mask[c_base + e] != 0 &&
            route::stage_source(a, j, e >> 7, e & 127, ri, li))
            v = y[route::tile_offset(j, ri, li, R_q, Q, n_chunks)];
        buf[e] = v;
    }
    block_barrier();

    // 2. denominators and scaling, in place
    scale_chunk(buf, lvl + c_base, mult != nullptr ? mult + c_base : nullptr,
                R_c, max_lvl, thresh);
    block_barrier();

    // 3. route B's expand stage out of the chunk buffer
    const int64_t q_base = (int64_t)j * n_q;
    for (int e = threadIdx.x; e < n_q; e += THREADS) {
        T v = T(0);
        int ri, li;
        if (route::stage_source(b, j, e >> 7, e & 127, ri, li))
            v = buf[ri * route::LANES + li];
        out[q_base + e] = v;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) route_middle_replicates_kernel(
    const T* __restrict__ y,             // B x quota values (tile_offset)
    const int8_t* __restrict__ lvl,      // [n_chunks * R_c, 128]
    route::StageTables a,                // route A reduce: R_q -> R_c
    const int8_t* __restrict__ a_mask,   // [n_chunks, R_c, 128]
    route::StageTables b,                // route B expand: R_c -> R_q
    const T* __restrict__ mult,          // [B, n_chunks * R_c, 128] or nullptr
    T* __restrict__ out,                 // [B, n_chunks * R_q, 128]
    T* scratch,                          // [n_chunks * R_c, 128] or nullptr
    int32_t* sources,                    // [n_chunks, (R_c + R_q) * 128]
    int n_chunks, int Q, int max_lvl, T thresh, int B)
{
    extern __shared__ __align__(16) unsigned char shared_raw[];
    const int j = blockIdx.x;
    const int R_q = a.R_in, R_c = a.R_out;
    const int n_c = R_c * route::LANES, n_q = R_q * route::LANES;
    const int64_t c_base = (int64_t)j * n_c, q_base = (int64_t)j * n_q;
    T* buf = scratch != nullptr ? scratch + c_base
                                : reinterpret_cast<T*>(shared_raw);

    // 0. The source of every element of both stages, once for all
    // replicates: the offset into one replicate's quota values for stage A
    // (below 2^31, the wrapper checks), the slot of the chunk buffer for
    // stage B, -1 for an element that stays 0. A thread later reads only
    // the entries it wrote here, so no barrier stands between.
    int32_t* src_a = sources + (int64_t)j * (n_c + n_q);
    int32_t* src_b = src_a + n_c;
    for (int e = threadIdx.x; e < n_c; e += THREADS) {
        int32_t s = -1;
        int ri, li;
        if (a_mask[c_base + e] != 0 &&
            route::stage_source(a, j, e >> 7, e & 127, ri, li))
            s = (int32_t)route::tile_offset(j, ri, li, R_q, Q, n_chunks);
        src_a[e] = s;
    }
    for (int e = threadIdx.x; e < n_q; e += THREADS) {
        int ri, li;
        src_b[e] = route::stage_source(b, j, e >> 7, e & 127, ri, li)
                       ? ri * route::LANES + li : -1;
    }

    const int64_t q_rep = (int64_t)n_chunks * n_q;  // replicate strides
    const int64_t c_rep = (int64_t)n_chunks * n_c;
    // Per replicate the two moves take UNROLL elements a thread at once
    // (offsets, then values, then stores), so that a thread has that many
    // loads in flight; n_c and n_q are multiples of 128 * 128.
    for (int rep = 0; rep < B; ++rep) {
        // 1. route A's reduce stage into the chunk buffer
        const T* y_rep = y + rep * q_rep;
        for (int e0 = threadIdx.x; e0 < n_c; e0 += THREADS * UNROLL) {
            int32_t s[UNROLL];
            T v[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) s[u] = src_a[e0 + u * THREADS];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                v[u] = s[u] >= 0 ? y_rep[s[u]] : T(0);
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) buf[e0 + u * THREADS] = v[u];
        }
        block_barrier();

        // 2. denominators and scaling, in place
        scale_chunk(buf, lvl + c_base,
                    mult != nullptr ? mult + rep * c_rep + c_base : nullptr,
                    R_c, max_lvl, thresh);
        block_barrier();

        // 3. route B's expand stage out of the chunk buffer
        T* out_rep = out + rep * q_rep + q_base;
        for (int e0 = threadIdx.x; e0 < n_q; e0 += THREADS * UNROLL) {
            int32_t s[UNROLL];
            T v[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) s[u] = src_b[e0 + u * THREADS];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                v[u] = s[u] >= 0 ? buf[s[u]] : T(0);
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                out_rep[e0 + u * THREADS] = v[u];
        }
        block_barrier();  // the next replicate re-uses the buffer
    }
}

template <typename T>
int launch(const void* y, const void* lvl, const void* a_r1,
           const void* a_src, const void* a_row, const void* a_r2,
           const void* a_mask, const void* b_r1, const void* b_src,
           const void* b_row, const void* b_r2, const void* mult, void* out,
           void* scratch, void* sources, int n_chunks, int R_q, int R_c,
           int Q, int max_lvl, double thresh, int B, void* stream)
{
    if (n_chunks == 0) return (int)cudaSuccess;
    route::StageTables a{(const int8_t*)a_r1, (const int8_t*)a_src,
                         (const int8_t*)a_row, (const int8_t*)a_r2, R_q, R_c};
    route::StageTables b{(const int8_t*)b_r1, (const int8_t*)b_src,
                         (const int8_t*)b_row, (const int8_t*)b_r2, R_c, R_q};
    const bool replicates = B > 0;  // B == 0: no replicate axis
    if (replicates && sources == nullptr) return (int)cudaErrorInvalidValue;
    size_t shared = 0;
    if (scratch == nullptr) {
        shared = (size_t)R_c * route::LANES * sizeof(T);
        if (shared > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
        cudaError_t err = replicates
            ? cudaFuncSetAttribute(
                  route_middle_replicates_kernel<T>,
                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)
            : cudaFuncSetAttribute(
                  route_middle_kernel<T>,
                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
        if (err != cudaSuccess) return (int)err;
    }
    if (replicates)
        route_middle_replicates_kernel<T><<<n_chunks, THREADS, shared,
                                            (cudaStream_t)stream>>>(
            (const T*)y, (const int8_t*)lvl, a, (const int8_t*)a_mask, b,
            (const T*)mult, (T*)out, (T*)scratch, (int32_t*)sources,
            n_chunks, Q, max_lvl, (T)thresh, B);
    else
        route_middle_kernel<T><<<n_chunks, THREADS, shared,
                                 (cudaStream_t)stream>>>(
            (const T*)y, (const int8_t*)lvl, a, (const int8_t*)a_mask, b,
            (const T*)mult, (T*)out, (T*)scratch, n_chunks, Q, max_lvl,
            (T)thresh);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B == 0: values without a replicate axis (`sources` unused); B > 0: B
// replicates (`sources` [n_chunks, (R_c + R_q) * 128] int32 scratch).
int route_middle_f32(const void* y, const void* lvl, const void* a_r1,
                     const void* a_src, const void* a_row, const void* a_r2,
                     const void* a_mask, const void* b_r1, const void* b_src,
                     const void* b_row, const void* b_r2, const void* mult,
                     void* out, void* scratch, void* sources, int n_chunks,
                     int R_q, int R_c, int Q, int max_lvl, double thresh,
                     int B, void* stream)
{
    return launch<float>(y, lvl, a_r1, a_src, a_row, a_r2, a_mask, b_r1,
                         b_src, b_row, b_r2, mult, out, scratch, sources,
                         n_chunks, R_q, R_c, Q, max_lvl, thresh, B, stream);
}

int route_middle_f64(const void* y, const void* lvl, const void* a_r1,
                     const void* a_src, const void* a_row, const void* a_r2,
                     const void* a_mask, const void* b_r1, const void* b_src,
                     const void* b_row, const void* b_r2, const void* mult,
                     void* out, void* scratch, void* sources, int n_chunks,
                     int R_q, int R_c, int Q, int max_lvl, double thresh,
                     int B, void* stream)
{
    return launch<double>(y, lvl, a_r1, a_src, a_row, a_r2, a_mask, b_r1,
                          b_src, b_row, b_r2, mult, out, scratch, sources,
                          n_chunks, R_q, R_c, Q, max_lvl, thresh, B, stream);
}

}  // extern "C"
