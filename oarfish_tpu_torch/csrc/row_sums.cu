// Fixed-order row sums of the routed (v4) EM's slot layouts:
//   out[b, o] = x[b, a] + x[b, a + W] + ... + x[b, a + (K - 1) * W],
//   a = base + (q / W) * K * W + q % W,   q = o - off,
// for output o of the table entry (off, base, K, W) whose outputs hold it.
// A bucket of the column-major layout (rows_pad rows of K slots, groups of
// 128 rows, its first slot at base) is one entry with W = 128: output q is
// bucket row q. A run of K consecutive values (a big transcript's rows in
// the second level) is one entry with W = 1 and a single output.
//
// Replaces the glue's row sums of the JAX package's ops/em_v4.py
// (`_row_sums`: one reduction per bucket over a [groups, K, 128] view; the
// big-transcript second level: differences of a cumsum). Those are XLA
// reductions, not a Pallas kernel. In the port they were torch's `sum` and
// `cumsum`, whose order of addition on the card depends on the number of
// outputs, so a bootstrap replicate's last bits depended on its batch.
// Here one thread makes one output of one replicate and adds its K values
// in a fixed order: windows of WINDOW = 32 values in index order, then the
// window sums, again in windows of 32 in index order, and so on (three
// levels, K up to 32^3). That is the order in which XLA's CPU backend
// reduces such a row (its tree-reduction rewrite), so on the CPU the plain
// version gives the JAX package's bucket sums bit for bit (for the
// layout's power-of-two K); on the card every replicate gets the same bits
// alone or in any batch. Every bucket of a layout is one launch.
//
// Bound: bytes. Each value is read once and each sum written once; the
// table (a few entries) stays in L1. A warp's 32 threads read 32
// neighbouring values of one bucket per step. A bucket of wide rows (K up
// to 2048 in the big-transcript region) keeps its few threads looping
// long: 64 windows one after another, each one load latency with its 32
// loads in flight. That tail, not the bytes, is what a launch waits for.
//
// Plain C interface for ctypes; the wrapper (oarfish_tpu_torch/ops/
// row_sums.py) checks the table once, allocates the output and passes the
// current stream. Each entry point returns cudaGetLastError() of its
// launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr long long WINDOW = 32;

// n values p[k0 W], p[(k0 + 1) W], ... added in index order. A whole window
// loads its 32 values into registers first, so that they are in flight
// together, then adds them.
template <typename T>
__device__ __forceinline__ T window(const T* __restrict__ p, long long W,
                                    long long k0, long long n)
{
    if (n == WINDOW) {
        T v[WINDOW];
#pragma unroll
        for (int j = 0; j < WINDOW; ++j) v[j] = p[(k0 + j) * W];
        T acc = v[0];
#pragma unroll
        for (int j = 1; j < WINDOW; ++j) acc += v[j];
        return acc;
    }
    T acc = p[k0 * W];
#pragma unroll 8
    for (long long k = k0 + 1; k < k0 + n; ++k) acc += p[k * W];
    return acc;
}

// The values p[0], p[W], ..., p[(K - 1) W] added in windows of WINDOW, each
// level's sums in windows again: the first value of a window starts it.
template <typename T>
__device__ __forceinline__ T window_sum(const T* __restrict__ p, long long W,
                                        long long K)
{
    const long long n_windows = (K + WINDOW - 1) / WINDOW;
    T top = 0;
    for (long long s = 0; s * WINDOW < n_windows; ++s) {
        T mid = 0;
        const long long c_end = min((s + 1) * WINDOW, n_windows);
        for (long long c = s * WINDOW; c < c_end; ++c) {
            const long long k0 = c * WINDOW;
            const T inner = window(p, W, k0, min(WINDOW, K - k0));
            mid = c == s * WINDOW ? inner : mid + inner;
        }
        top = s == 0 ? mid : top + mid;
    }
    return top;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) row_sums_kernel(
    const T* __restrict__ x, long long x_stride,
    const long long* __restrict__ table, int n_entries, long long n_out,
    T* __restrict__ out)
{
    const long long o = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (o >= n_out) return;
    // the last entry whose first output is at or before o
    int lo = 0, hi = n_entries - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(table + 4 * mid) <= o) {
            lo = mid;
        } else {
            hi = mid - 1;
        }
    }
    const long long* e = table + 4 * lo;
    const long long q = o - __ldg(e);
    const long long K = __ldg(e + 2), W = __ldg(e + 3);
    const T* p = x + (long long)blockIdx.y * x_stride + __ldg(e + 1)
                 + (q / W) * K * W + q % W;
    out[(long long)blockIdx.y * n_out + o] = window_sum(p, W, K);
}

template <typename T>
int launch(const void* x, long long x_stride, const void* table,
           int n_entries, long long n_out, int B, void* out, void* stream)
{
    const dim3 grid((unsigned)((n_out + THREADS - 1) / THREADS), B);
    row_sums_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, x_stride, (const long long*)table, n_entries, n_out,
        (T*)out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: B replicates of values, x_stride apart; table: [n_entries, 4] int64
// (first output, first value, K <= 32^3, W) on the device, first outputs
// ascending from 0; out: [B, n_out]
int row_sums_f32(const void* x, long long x_stride, const void* table,
                 int n_entries, long long n_out, int B, void* out,
                 void* stream)
{
    return launch<float>(x, x_stride, table, n_entries, n_out, B, out,
                         stream);
}

int row_sums_f64(const void* x, long long x_stride, const void* table,
                 int n_entries, long long n_out, int B, void* out,
                 void* stream)
{
    return launch<double>(x, x_stride, table, n_entries, n_out, B, out,
                          stream);
}

}  // extern "C"
