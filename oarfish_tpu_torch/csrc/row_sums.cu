// Fixed-order row sums of the routed (v4) EM's slot layouts, with an
// optional second level, in one launch.
//
// A row sum reads, for output q of a table entry (base, K, W),
//   x[a] + x[a + W] + ... + x[a + (K - 1) W],
//   a = base + (q / W) K W + q % W.
// A bucket of the column-major layout (rows_pad rows of K slots, groups of
// 128 rows) is one entry with W = 128; a run of K consecutive values is one
// entry with W = 1. The second level adds consecutive row sums (a big
// transcript's rows of CAPK slots) into one output. Every sum adds in a
// fixed order: windows of WINDOW = 32 values in index order, then the
// window sums, again in windows of 32 in index order, then those (three
// levels, K up to 32^3). That is the order in which XLA's CPU backend
// reduces such a row, so the plain version (ops/row_sums.py) gives the JAX
// package's bucket sums bit for bit, and every replicate gets the same bits
// alone or in any batch.
//
// Replaces the glue's row sums of the JAX package's ops/em_v4.py
// (`_row_sums`: one reduction per bucket; the big-transcript second level:
// differences of a cumsum; then the concatenation with a zero tail that the
// output tile permute takes). Those are XLA reductions, not a Pallas kernel.
//
// Bound: bytes. Each value is read once and each output written once. The
// work is a list of tiles made once per layout on the host
// (ops/row_sums.py::RowSumPlan), one block each:
//  * a tile is `lanes` neighbouring outputs of one entry (32 where the
//    entry is wide: in a W = 128 bucket one 128-byte line of each slot),
//    all their windows: thread p adds window p / lanes of output p % lanes
//    (and p + 512 ...), its 32 loads in flight together, so a 2048-wide
//    row costs a few windows of load latency (4 a thread), not 64 one
//    after another. The window sums go to shared memory, where the upper
//    levels are added in index order, one thread per output and window of
//    windows, then one per output.
//  * a tile of second-level rows writes its row sums to a scratch area
//    instead of the output, then counts itself on the arrival counter of
//    each group its rows fall in; a warp of the last tile to arrive at a
//    group adds the group's row sums, read back in index order, in the
//    same windows, writes the output and sets the counter back to 0 for
//    the next launch. The order of arrival changes no bit. Tiles are not
//    cut at the groups' edges, so that each reads whole lines, and the
//    groups that one tile finishes (up to 16 big transcripts of 2 rows)
//    are added side by side, a warp each. (A thread-block cluster per
//    group would hold at most 16 blocks; a big transcript has up to
//    thousands of rows.)
//  * a zero tile writes the output's zero tail.
// Replicates are the grid's y axis: the tiles, and so every output's order,
// do not depend on the replicate count. Counters and scratch are per
// replicate and belong to the plan, which serves one stream at a time.
//
// Plain C interface for ctypes; the wrapper checks the plan once, where it
// is made, allocates the output and passes the current stream. Each entry
// point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int WINDOW = 32;
constexpr int WS_SLOTS = 2048;  // window sums of a tile in shared memory
constexpr int MID_SLOTS = 64;   // sums of 32 window sums of a tile
constexpr int TILE = 7;         // int64 fields of a tile
constexpr int COMBINE = 4;      // int64 fields of a second-level group

template <typename T, bool COHERENT>
__device__ __forceinline__ T load(const T* p)
{
    // scratch written by other blocks of this launch is read through L2
    return COHERENT ? __ldcg(p) : __ldg(p);
}

// n <= WINDOW values p[0], p[W], ... added in index order, all loads issued
// before the first addition.
template <typename T, bool COHERENT>
__device__ __forceinline__ T window(const T* __restrict__ p, long long W,
                                    int n)
{
    T v[WINDOW];
#pragma unroll
    for (int j = 0; j < WINDOW; ++j) {
        if (j < n) v[j] = load<T, COHERENT>(p + j * W);
    }
    T acc = v[0];
#pragma unroll
    for (int j = 1; j < WINDOW; ++j) {
        if (j < n) acc += v[j];
    }
    return acc;
}

template <typename T>
struct Smem {
    T ws[WS_SLOTS];
    T mid[MID_SLOTS];
    T res[THREADS];
};

// The window sums of outputs q0 .. q0 + lanes - 1 of the entry (base, K,
// W) over x, by the whole block, into sh.ws[j * lanes + l]; then the upper
// levels, in index order, into sh.res[0 .. lanes). The plan keeps
// lanes * windows <= WS_SLOTS and, above WINDOW windows, lanes * (windows
// of windows) <= MID_SLOTS.
template <typename T>
__device__ void block_sums(const T* __restrict__ x, long long base,
                           long long q0, int lanes, long long K, long long W,
                           Smem<T>& sh)
{
    const int nw = (int)((K + WINDOW - 1) / WINDOW);
    for (int p = threadIdx.x; p < lanes * nw; p += THREADS) {
        const int l = p % lanes, j = p / lanes;
        const long long q = q0 + l;
        const long long k0 = (long long)j * WINDOW;
        const T* row = x + base + (q / W) * K * W + q % W;
        sh.ws[p] = window<T, false>(row + k0 * W, W,
                                    (int)min((long long)WINDOW, K - k0));
    }
    __syncthreads();
    if (nw <= WINDOW) {
        for (int l = threadIdx.x; l < lanes; l += THREADS) {
            T acc = sh.ws[l];
            for (int j = 1; j < nw; ++j) acc += sh.ws[j * lanes + l];
            sh.res[l] = acc;
        }
    } else {
        const int nc = (nw + WINDOW - 1) / WINDOW;
        for (int p = threadIdx.x; p < lanes * nc; p += THREADS) {
            const int l = p % lanes, c = p / lanes;
            const int j_end = min((c + 1) * WINDOW, nw);
            T acc = sh.ws[c * WINDOW * lanes + l];
            for (int j = c * WINDOW + 1; j < j_end; ++j) {
                acc += sh.ws[j * lanes + l];
            }
            sh.mid[p] = acc;
        }
        __syncthreads();
        for (int l = threadIdx.x; l < lanes; l += THREADS) {
            T acc = sh.mid[l];
            for (int c = 1; c < nc; ++c) acc += sh.mid[c * lanes + l];
            sh.res[l] = acc;
        }
    }
    __syncthreads();
}

// p[0] + ... + p[n - 1] (n <= WINDOW^3) in the same order, by one warp:
// lane i adds windows i, i + 32, ...; each window of 32 window sums is
// added in index order through the warp's shuffles, then those.
template <typename T>
__device__ T warp_sum(const T* p, long long n)
{
    const int lane = threadIdx.x % WINDOW;
    const int nw = (int)((n + WINDOW - 1) / WINDOW);
    T top = 0;
    for (int c = 0; c * WINDOW < nw; ++c) {
        const long long k0 = (long long)(c * WINDOW + lane) * WINDOW;
        const int len = (int)min((long long)WINDOW, n - k0);
        const T w = k0 < n ? window<T, true>(p + k0, 1, len) : T(0);
        const int in_chunk = min(WINDOW, nw - c * WINDOW);
        T mid = __shfl_sync(0xffffffffu, w, 0);
        for (int i = 1; i < in_chunk; ++i) {
            mid += __shfl_sync(0xffffffffu, w, i);
        }
        top = c == 0 ? mid : top + mid;
    }
    return top;
}

// tile: (destination, base, q0, lanes, K, W, group). K = 0: a zero tile
// of `lanes` outputs from `destination`. group -1: the row sums go to the
// outputs from `destination`; else to the scratch slots from
// `destination`, the tile's rows falling in that group and maybe the next
// ones. group: (output, first slot, rows, tiles whose rows fall in it).
template <typename T>
__global__ void __launch_bounds__(THREADS) row_sums_kernel(
    const T* __restrict__ x, long long x_stride,
    const long long* __restrict__ tiles,
    const long long* __restrict__ groups, int n_groups, long long n_out,
    T* __restrict__ out, T* scratch, long long n_scratch, int* counters)
{
    __shared__ Smem<T> sh;
    __shared__ int last[THREADS];
    const long long* t = tiles + (long long)TILE * blockIdx.x;
    const long long dest = __ldg(t), base = __ldg(t + 1), q0 = __ldg(t + 2);
    const int lanes = (int)__ldg(t + 3);
    const long long K = __ldg(t + 4), W = __ldg(t + 5), g = __ldg(t + 6);
    const long long b = blockIdx.y;
    T* o = out + b * n_out;
    if (K == 0) {
        for (int i = threadIdx.x; i < lanes; i += THREADS) o[dest + i] = T(0);
        return;
    }
    block_sums(x + b * x_stride, base, q0, lanes, K, W, sh);
    if (g < 0) {
        for (int l = threadIdx.x; l < lanes; l += THREADS) {
            o[dest + l] = sh.res[l];
        }
        return;
    }
    T* s = scratch + b * n_scratch;
    for (int l = threadIdx.x; l < lanes; l += THREADS) {
        s[dest + l] = sh.res[l];
    }
    __threadfence();
    __syncthreads();
    // the groups the rows fall in: g, g + 1, ..., g + ng - 1
    const long long* grp = groups + COMBINE * g;
    int ng = 1;
    while (g + ng < n_groups && __ldg(grp + COMBINE * ng + 1) < dest + lanes) {
        ++ng;
    }
    int* counter = counters + b * n_groups + g;
    for (int i = threadIdx.x; i < ng; i += THREADS) {
        last[i] = atomicAdd(counter + i, 1)
                  == (int)__ldg(grp + COMBINE * i + 3) - 1;
        if (last[i]) counter[i] = 0;
    }
    __syncthreads();
    // each group this block came last to is added by a warp of its own
    for (int i = threadIdx.x / WINDOW; i < ng; i += THREADS / WINDOW) {
        if (!last[i]) continue;
        __threadfence();
        const T sum = warp_sum(s + __ldg(grp + COMBINE * i + 1),
                               __ldg(grp + COMBINE * i + 2));
        if (threadIdx.x % WINDOW == 0) o[__ldg(grp + COMBINE * i)] = sum;
    }
}

template <typename T>
int launch(const void* x, long long x_stride, const void* tiles, int n_tiles,
           const void* groups, int n_groups, long long n_out, int B,
           void* out, void* scratch, long long n_scratch, void* counters,
           void* stream)
{
    const dim3 grid((unsigned)n_tiles, (unsigned)B);
    row_sums_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, x_stride, (const long long*)tiles,
        (const long long*)groups, n_groups, n_out, (T*)out, (T*)scratch,
        n_scratch, (int*)counters);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: B replicates of values, x_stride apart; tiles: [n_tiles, 7] int64
// and groups: [n_groups, 4] int64 on the device (ops/row_sums.py::
// RowSumPlan); out: [B, n_out]; scratch: at least B * n_scratch values;
// counters: [B, n_groups] int32, all 0 before the launch and after it.
int row_sums_f32(const void* x, long long x_stride, const void* tiles,
                 int n_tiles, const void* groups, int n_groups,
                 long long n_out, int B, void* out, void* scratch,
                 long long n_scratch, void* counters, void* stream)
{
    return launch<float>(x, x_stride, tiles, n_tiles, groups, n_groups,
                         n_out, B, out, scratch, n_scratch, counters,
                         stream);
}

int row_sums_f64(const void* x, long long x_stride, const void* tiles,
                 int n_tiles, const void* groups, int n_groups,
                 long long n_out, int B, void* out, void* scratch,
                 long long n_scratch, void* counters, void* stream)
{
    return launch<double>(x, x_stride, tiles, n_tiles, groups, n_groups,
                          n_out, B, out, scratch, n_scratch, counters,
                          stream);
}

}  // extern "C"
