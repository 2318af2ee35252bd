// Fused EM middle, per read chunk j and replicate b:
//   1. x  = route A's reduce stage on chunk j's quota tile [R_q, 128]
//           -> chunk space [R_c, 128], uncovered slots exactly 0;
//   2. per-read denominators: every row r of the chunk at lane c takes the
//      sum, at that lane, of the aligned block of 2^lvl rows that holds r,
//      added as a balanced binary tree (the JAX kernel's butterfly, whose
//      level s adds the partner at row XOR 2^(s-1)); rows with lvl < 0 or
//      lvl > max_lvl take 0; scale = denom > thresh ? 1/denom : 0;
//      xs = x * scale (* mult);
//   3. out = route B's expand stage on xs -> quota tile [R_q, 128].
//
// Replaces the Pallas kernel of ops/static_permute.py of the JAX package
// (`_make_middle_kernel` / `_run_middle_stage`). That kernel keeps a whole
// chunk in its large on-chip memory, walks both stages' int8 tables as
// whole-tile lane gathers and transposes, and computes the denominators
// with a butterfly of sublane rolls over the full tile, every row at every
// level, selecting each row's level afterwards.
//
// Here both stages read the source offsets that the plan composed once
// from their tables (route_common.cuh; `Stage.off` of the wrapper): one
// offset per element, -1 where the element is 0, the reduce stage's mask
// folded in. Phase 1 reads route A's reduce offsets (int32 for a 512-row
// quota tile, int16 up to 256 rows), 8 a thread in one or two 16-byte
// loads, and gathers their values out of the quota view (the multiply-high
// split of route_common.cuh) or out of tiles that lie one after another;
// phase 3 reads route B's expand offsets (int16 up to 256 chunk rows) and
// gathers out of the scaled chunk. Every load of offsets and every store
// of the output is coalesced, 16 bytes a thread.
//
// One block of 1,024 threads per chunk. The chunk lives in the block's shared
// memory where chunk and tree fit (at most 227 KB a block on this card:
// chunks of 128 and 256 rows in f32, 128 in f64), else in a scratch area of
// its own in device memory (`middle_variant` of the wrapper: "block" or
// "scratch"). Phase 3 may read any element of the scaled chunk, so a
// block-wide barrier separates the phases (`__syncthreads` makes a block's
// writes to shared and to device memory visible to the whole block). A
// 256-row f32 chunk fills an SM's shared memory, so the three phases of a
// block overlap no other block's; a cluster of two blocks, each with half the
// chunk and reading the other half through distributed shared memory in phase
// 3, let two blocks share an SM but was slower at the bench plan in both arms
// (PERF.md section 6), and was not kept.
//
// The denominators (phase 2): in IEEE arithmetic a + b == b + a, so a
// level of the butterfly gives every row of an aligned block of 2^s rows
// the same bits, the tree node (lower half) + (upper half). A thread takes
// one lane of an aligned segment of 16 rows and adds its tree, levels 1 to
// 4, in registers; the segments' sums go to a small tree area beside the
// chunk, where levels 5 to max_lvl are added level by level, every thread
// at every level, one barrier each. A row then reads the node of its own
// level. This needs no property of the level table: any row may name any
// level, as in the plain version.
//
// Replicate axis (the `B > 0` arm of `_make_middle_kernel`): values,
// `mult` and output carry a leading axis of B replicates; both routes'
// offsets and `lvl` are shared. The JAX kernel loops over the replicates
// around the whole body and repeats every table gather B times. Here each
// replicate of a chunk has its own block, the B of a chunk side by side
// in the grid: they run together, so the chunk's offsets and
// levels cross device memory once and come from L2 for the others (a
// block that loops over the replicates ran at half the speed for the route
// stage, PERF.md section 6). A launch without the axis is the same kernel at
// B = 1, so each replicate is computed exactly as a launch without the
// axis computes it.
//
// Bound: bytes. Per chunk and replicate the quota tile is read and written
// once, with one offset per chunk element and one per quota element, the
// level byte per chunk element, and `mult` where given; the sums are one
// add, a division and one or two products per chunk element.
//
// Built without fused multiply-add and without fast-math: the kernel is
// held bit for bit against its plain version. Plain C interface for
// ctypes; the wrapper (oarfish_tpu_torch/ops/route_middle.py) allocates
// output and scratch, checks the values and passes the current stream
// (the offsets were checked where the plan was built). Each entry point
// returns the first CUDA error of its launch.

#include "route_common.cuh"

namespace {

constexpr int THREADS = 1024;
// SEG_LOG, MAX_LEVELS and tree_rows are mirrored by SEGMENT_LEVELS,
// MAX_LEVELS and tree_rows of the wrapper, which sizes the area a block
// needs; tests/test_torch_route_middle.py holds the two in step.
constexpr int SEG_LOG = 4;  // a thread sums 16 rows of one lane in registers
constexpr int SEG = 1 << SEG_LOG;
constexpr int MAX_LEVELS = 11;
constexpr size_t SMEM_LIMIT = 227 * 1024;  // opt-in maximum of a block

// Rows (of 128 lanes) of the tree area: the nodes of levels SEG_LOG to
// max_lvl, level after level; none where a segment holds every level.
__host__ __device__ __forceinline__ int tree_rows(int R_c, int max_lvl)
{
    int rows = 0;
    if (max_lvl > SEG_LOG)
        for (int s = SEG_LOG; s <= max_lvl; ++s) rows += R_c >> s;
    return rows;
}

// First row of level s (SEG_LOG <= s <= max_lvl) in the tree area.
__device__ __forceinline__ int tree_level_row(int R_c, int s)
{
    int rows = 0;
    for (int t = SEG_LOG; t < s; ++t) rows += R_c >> t;
    return rows;
}

// The balanced tree of one lane c of the segment of 16 rows that starts at
// row r0 of the chunk buffer: t1[i] = rows 2i, 2i+1; t2 of t1; t3; t4.
template <typename T>
struct SegmentTree {
    T t1[8], t2[4], t3[2], t4;

    __device__ __forceinline__ SegmentTree(const T* buf, int r0, int c)
    {
#pragma unroll
        for (int i = 0; i < 8; ++i)
            t1[i] = buf[(r0 + 2 * i) * route::LANES + c] +
                    buf[(r0 + 2 * i + 1) * route::LANES + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) t2[i] = t1[2 * i] + t1[2 * i + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i) t3[i] = t2[2 * i] + t2[2 * i + 1];
        t4 = t3[0] + t3[1];
    }
};

// Offset vectors a thread has in flight: f64 keeps fewer, registers are
// capped at 64 a thread.
template <typename T>
__host__ __device__ constexpr int batch() { return sizeof(T) == 4 ? 2 : 1; }

// Phase 1 on the n elements of a chunk (a multiple of THREADS * VEC *
// batch): buf[e] = y_b[source of off[e]], 0 where off[e] < 0. Each value is
// a load through L2, where the quota tile of the chunk stays while its
// block runs. (Passing the tile through shared memory in 64 KB parts, with
// 16-byte loads, was slower at the bench plan, PERF.md section 6.)
template <typename T, typename Off>
__device__ __forceinline__ void reduce_into(
    T* buf, const Off* __restrict__ off, const T* __restrict__ y_b,
    const route::Layout& l, int j, int n)
{
    constexpr int BATCH = batch<T>();
    for (int e0 = threadIdx.x * route::VEC; e0 < n;
         e0 += THREADS * route::VEC * BATCH) {
        int o[BATCH][route::VEC];
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
            route::load_offsets(off + e0 + k * THREADS * route::VEC, o[k]);
        T v[BATCH][route::VEC];
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
#pragma unroll
            for (int i = 0; i < route::VEC; ++i)
                v[k][i] = o[k][i] < 0 ? T(0)
                                      : y_b[route::source_offset(l, j, o[k][i])];
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
            route::store_values(buf + e0 + k * THREADS * route::VEC, v[k]);
    }
}

// Phase 2 on the `rows` rows of a chunk in `buf` (the tree area after
// them): denominators and scaling, in place. `lvl` and `mult` (or nullptr)
// point at the same rows. A work item is one lane c of one segment g of 16
// rows; a warp takes 32 lanes of one segment.
template <typename T>
__device__ __forceinline__ void scale_rows(
    T* buf, const int8_t* __restrict__ lvl, const T* __restrict__ mult,
    int rows, int max_lvl, T thresh)
{
    T* tree = buf + rows * route::LANES;
    const int n_items = (rows / SEG) * route::LANES;
    if (max_lvl > SEG_LOG) {
        // the segments' sums are the tree's level SEG_LOG ...
        for (int it = threadIdx.x; it < n_items; it += THREADS) {
            const SegmentTree<T> st(buf, (it >> 7) * SEG, it & 127);
            tree[it] = st.t4;
        }
        // ... and each further level adds two nodes of the one below
        int below = 0;
        for (int s = SEG_LOG + 1; s <= max_lvl; ++s) {
            __syncthreads();
            const int at = below + (rows >> (s - 1)) * route::LANES;
            const int nodes = (rows >> s) * route::LANES;
            for (int it = threadIdx.x; it < nodes; it += THREADS) {
                const int p = it >> 7, c = it & 127;
                tree[at + it] = tree[below + (2 * p) * route::LANES + c] +
                                tree[below + (2 * p + 1) * route::LANES + c];
            }
            below = at;
        }
        __syncthreads();
    }
    for (int it = threadIdx.x; it < n_items; it += THREADS) {
        const int g = it >> 7, c = it & 127;
        const SegmentTree<T> st(buf, g * SEG, c);
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
            const int r = g * SEG + i;
            const int e = r * route::LANES + c;
            const int L = lvl[e];
            const T x = buf[e];
            T denom = T(0);
            if (L >= 0 && L <= max_lvl) {
                if (L == 0) denom = x;
                else if (L == 1) denom = st.t1[i >> 1];
                else if (L == 2) denom = st.t2[i >> 2];
                else if (L == 3) denom = st.t3[i >> 3];
                else if (L == 4) denom = st.t4;
                else
                    denom = tree[(tree_level_row(rows, L) + (r >> L)) *
                                     route::LANES + c];
            }
            const T scale = denom > thresh ? T(1) / denom : T(0);
            T xs = x * scale;
            if (mult != nullptr) xs = xs * mult[e];
            buf[e] = xs;
        }
    }
}

// Phase 3 on the n outputs of a chunk (a multiple of THREADS * VEC *
// batch): out[e] = off[e] < 0 ? 0 : buf[off[e]].
template <typename T, typename Off>
__device__ __forceinline__ void expand_from(
    const T* buf, const Off* __restrict__ off, T* __restrict__ out, int n)
{
    constexpr int BATCH = batch<T>();
    for (int e0 = threadIdx.x * route::VEC; e0 < n;
         e0 += THREADS * route::VEC * BATCH) {
        int o[BATCH][route::VEC];
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
            route::load_offsets(off + e0 + k * THREADS * route::VEC, o[k]);
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
            T v[route::VEC];
#pragma unroll
            for (int i = 0; i < route::VEC; ++i)
                v[i] = o[k][i] < 0 ? T(0) : buf[o[k][i]];
            route::store_values(out + e0 + k * THREADS * route::VEC, v);
        }
    }
}

template <typename T, typename OffA, typename OffB>
__global__ void __launch_bounds__(THREADS) route_middle_kernel(
    const T* __restrict__ y,        // B x quota values (route::source_offset)
    const int8_t* __restrict__ lvl,      // [n_chunks * R_c, 128]
    const OffA* __restrict__ off_a,      // [n_chunks, R_c, 128] in [-1, R_q*128)
    const OffB* __restrict__ off_b,      // [n_chunks, R_q, 128] in [-1, R_c*128)
    const T* __restrict__ mult,          // [B, n_chunks * R_c, 128] or nullptr
    T* __restrict__ out,                 // [B, n_chunks * R_q, 128]
    T* scratch,                          // [n_chunks * B, work] or nullptr
    route::Layout l, int R_c, int max_lvl, T thresh, int B)
{
    extern __shared__ __align__(16) unsigned char shared_raw[];
    const int j = blockIdx.x / B;
    const int b = blockIdx.x - j * B;
    const int n_c = R_c * route::LANES, n_q = l.R_in * route::LANES;
    const int work = n_c + tree_rows(R_c, max_lvl) * route::LANES;
    T* buf = scratch != nullptr ? scratch + (int64_t)blockIdx.x * work
                                : reinterpret_cast<T*>(shared_raw);
    const int64_t q_rep = (int64_t)l.n_chunks * n_q;  // replicate strides
    const int64_t c_rep = (int64_t)l.n_chunks * n_c;

    // 1. route A's reduce stage into the chunk buffer
    reduce_into(buf, off_a + (int64_t)j * n_c, y + b * q_rep, l, j, n_c);
    __syncthreads();
    // 2. denominators and scaling, in place
    scale_rows(buf, lvl + (int64_t)j * n_c,
               mult == nullptr ? nullptr : mult + b * c_rep + (int64_t)j * n_c,
               R_c, max_lvl, thresh);
    __syncthreads();
    // 3. route B's expand stage out of the chunk buffer
    expand_from(buf, off_b + (int64_t)j * n_q,
                out + b * q_rep + (int64_t)j * n_q, n_q);
}

template <typename T, typename OffA, typename OffB>
int launch_typed(const void* y, const void* lvl, const void* off_a,
                 const void* off_b, const void* mult, void* out,
                 void* scratch, const route::Layout& l, int R_c, int max_lvl,
                 double thresh, int B, cudaStream_t stream)
{
    const int64_t blocks = (int64_t)l.n_chunks * B;
    const auto kernel = route_middle_kernel<T, OffA, OffB>;
    size_t shared = 0;
    if (scratch == nullptr) {
        shared = ((size_t)R_c + tree_rows(R_c, max_lvl)) * route::LANES *
                 sizeof(T);
        if (shared > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(unsigned)blocks, THREADS, shared, stream>>>(
        (const T*)y, (const int8_t*)lvl, (const OffA*)off_a,
        (const OffB*)off_b, (const T*)mult, (T*)out, (T*)scratch, l, R_c,
        max_lvl, (T)thresh, B);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* y, const void* lvl, const void* off_a, int a_bytes,
           const void* off_b, int b_bytes, const void* mult, void* out,
           void* scratch, int n_chunks, int R_q, int R_c, int Q,
           unsigned long long q_inv, int max_lvl, double thresh, int B,
           void* stream)
{
    if (n_chunks == 0) return (int)cudaSuccess;
    // both loops over a chunk's elements step evenly: R_q and R_c are
    // multiples of 128 rows; levels stay inside the chunk
    if (B < 1 || R_q % route::LANES != 0 || R_c % route::LANES != 0 ||
        max_lvl < 0 || max_lvl > MAX_LEVELS || R_c % (1 << max_lvl) != 0 ||
        (int64_t)n_chunks * B >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const route::Layout l{R_q, n_chunks, Q, q_inv};
    const cudaStream_t s = (cudaStream_t)stream;
    if (a_bytes == 4 && b_bytes == 2)
        return launch_typed<T, int32_t, int16_t>(
            y, lvl, off_a, off_b, mult, out, scratch, l, R_c, max_lvl,
            thresh, B, s);
    if (a_bytes == 2 && b_bytes == 2)
        return launch_typed<T, int16_t, int16_t>(
            y, lvl, off_a, off_b, mult, out, scratch, l, R_c, max_lvl,
            thresh, B, s);
    if (a_bytes == 4 && b_bytes == 4)
        return launch_typed<T, int32_t, int32_t>(
            y, lvl, off_a, off_b, mult, out, scratch, l, R_c, max_lvl,
            thresh, B, s);
    if (a_bytes == 2 && b_bytes == 4)
        return launch_typed<T, int16_t, int32_t>(
            y, lvl, off_a, off_b, mult, out, scratch, l, R_c, max_lvl,
            thresh, B, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// a_bytes / b_bytes: 2 (int16 offsets) or 4 (int32) of route A's reduce
// and route B's expand stage; Q: 0 for tile-after-tile values, the quota
// for the quota view, with q_inv = ceil(2^32 / (Q / 128)); B >= 1 blocks a
// chunk (1 for values without a replicate axis); scratch: nullptr for the
// chunk and its tree in a block's shared memory, else [n_chunks * B, (R_c +
// tree rows) * 128] values in device memory.
int route_middle_f32(const void* y, const void* lvl, const void* off_a,
                     int a_bytes, const void* off_b, int b_bytes,
                     const void* mult, void* out, void* scratch, int n_chunks,
                     int R_q, int R_c, int Q, unsigned long long q_inv,
                     int max_lvl, double thresh, int B, void* stream)
{
    return launch<float>(y, lvl, off_a, a_bytes, off_b, b_bytes, mult, out,
                         scratch, n_chunks, R_q, R_c, Q, q_inv, max_lvl,
                         thresh, B, stream);
}

int route_middle_f64(const void* y, const void* lvl, const void* off_a,
                     int a_bytes, const void* off_b, int b_bytes,
                     const void* mult, void* out, void* scratch, int n_chunks,
                     int R_q, int R_c, int Q, unsigned long long q_inv,
                     int max_lvl, double thresh, int B, void* stream)
{
    return launch<double>(y, lvl, off_a, a_bytes, off_b, b_bytes, mult, out,
                          scratch, n_chunks, R_q, R_c, Q, q_inv, max_lvl,
                          thresh, B, stream);
}

}  // extern "C"
