// Sorted gather: out[b, r, l] = table[b, (base[r] + hi) * 128 + lane],
// where code[r, l] = lane | hi << 7 (lane in 0..127, hi in 0..1).
//
// Replaces the Pallas kernel of ops/gather_pallas.py of the JAX package
// (`_make_kernel` / `_run`). That kernel keeps the table as [S, 128] in
// VMEM and has no per-element gather to call on, so it delivers the two
// candidate table rows of every output row with one-hot matrix products
// and picks lanes with a shuffle. A GPU thread simply loads. The function
// is the same, including the edges: an element whose table row lies
// outside [0, S), or whose index is at or past the table's length n, is 0
// (the JAX package pads the table with zeros to S * 128).
//
// Bound: bytes. There is no arithmetic to speak of; per output element the
// kernel streams its code in and one value out per replicate, plus 4
// bytes of `base` per 128-element row. The tables ([B, n], under a
// megabyte each at transcriptome scale) are read once from device memory
// and then served by L1 and L2: the index is sorted, so a warp's reads
// fall in one or two 128-value table rows. What the design does about
// the bytes:
//   * one byte of index per element: the lane (7 bits) and the choice of
//     row (1 bit) share a byte, against the 4 + 1 of an int32 lane and a
//     byte flag;
//   * a row whose two candidate table rows both lie outside [0, S) (the
//     plan's pad rows, base -2) writes zeros without reading its codes;
//   * the table is read as it is, [B, n], with no padded copy made first;
//   * a thread takes 16 elements of one row, in 4 groups of 4 neighbours
//     32 elements apart, and eight threads a row: every load of codes
//     (4 bytes a thread) and every store (one float4, or two double2, a
//     thread) of a warp covers whole 32-byte sectors of 4 rows. A thread
//     that took 16 neighbouring elements (one 16-byte load of codes, four
//     float4 stores 64 bytes apart across the warp) wrote half sectors and
//     ran at half the memory rate;
//   * the replicate loop runs inside the thread, so the codes are read
//     once for all B tables.
//
// Plain C interface for ctypes; the wrapper
// (oarfish_tpu_torch/ops/sorted_gather.py) allocates the output, checks
// shapes and passes the current stream. Each entry point returns
// cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int GROUP = 4;                   // neighbouring elements
constexpr int GROUPS = 4;                  // groups a thread
constexpr int THREADS_PER_ROW = LANES / (GROUP * GROUPS);
constexpr int STRIDE = GROUP * THREADS_PER_ROW;  // elements between groups
constexpr int VEC = GROUP * GROUPS;        // elements a thread
constexpr int THREADS = 256;

__device__ __forceinline__ void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double* v) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) sorted_gather_kernel(
    const T* __restrict__ table,        // [B, n]
    const int32_t* __restrict__ base,   // [n_rows]
    const uint8_t* __restrict__ code,   // [n_rows, 128]
    T* __restrict__ out,                // [B, n_rows, 128]
    int64_t n_out,                      // n_rows * 128
    int64_t table_len,                  // n <= S * 128
    int32_t table_rows,                 // S
    int32_t batch)                      // B
{
    const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t row = v / THREADS_PER_ROW;
    // first element of this thread's first group; group j starts
    // STRIDE * j elements further on
    const int64_t i = row * LANES + GROUP * (v % THREADS_PER_ROW);
    if (i >= n_out) return;
    T* dst = out + i;
    const int32_t b0 = __ldg(base + row);
    if (b0 + 1 < 0 || b0 >= table_rows) {
        // both candidate rows outside the table: zeros, codes unread
        const T zero[GROUP] = {};
        for (int32_t b = 0; b < batch; ++b)
#pragma unroll
            for (int j = 0; j < GROUPS; ++j)
                store4(dst + b * n_out + STRIDE * j, zero);
        return;
    }
    uint32_t words[GROUPS];  // one code a byte, 4 to a word
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
        words[j] = __ldg(
            reinterpret_cast<const uint32_t*>(code + i + STRIDE * j));
    const int64_t row0 = (int64_t)b0 * LANES;
    // offset of each element from the start of its base row (0..255), and
    // which of them fall inside [0, n)
    uint32_t off[VEC];
    uint32_t inside = 0;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        const uint32_t byte = (words[k / GROUP] >> (8 * (k % GROUP))) & 0xffu;
        off[k] = (byte >> 7) * LANES + (byte & 0x7fu);
        const int64_t idx = row0 + off[k];
        inside |= (uint32_t)(idx >= 0 && idx < table_len) << k;
    }
    for (int32_t b = 0; b < batch; ++b) {
        const T* tab = table + b * table_len;
        T val[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            val[k] = (inside >> k) & 1u ? __ldg(tab + (row0 + off[k])) : T(0);
#pragma unroll
        for (int j = 0; j < GROUPS; ++j)
            store4(dst + b * n_out + STRIDE * j, val + GROUP * j);
    }
}

template <typename T>
int launch(const void* table, const void* base, const void* code, void* out,
           int64_t n_rows, int64_t table_len, int32_t table_rows,
           int32_t batch, void* stream)
{
    const int64_t n_out = n_rows * LANES;
    if (n_out == 0 || batch == 0) return (int)cudaSuccess;
    const int64_t n_threads = n_out / VEC;
    const unsigned grid = (unsigned)((n_threads + THREADS - 1) / THREADS);
    sorted_gather_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)table, (const int32_t*)base, (const uint8_t*)code, (T*)out,
        n_out, table_len, table_rows, batch);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sorted_gather_f32(const void* table, const void* base, const void* code,
                      void* out, int64_t n_rows, int64_t table_len,
                      int32_t table_rows, int32_t batch, void* stream)
{
    return launch<float>(table, base, code, out, n_rows, table_len,
                         table_rows, batch, stream);
}

int sorted_gather_f64(const void* table, const void* base, const void* code,
                      void* out, int64_t n_rows, int64_t table_len,
                      int32_t table_rows, int32_t batch, void* stream)
{
    return launch<double>(table, base, code, out, n_rows, table_len,
                          table_rows, batch, stream);
}

}  // extern "C"
