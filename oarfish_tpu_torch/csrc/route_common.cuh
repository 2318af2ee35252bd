// Shared by tile_permute.cu, route_stage.cu and route_middle.cu: how one
// stage of a static gather network finds the source of an output element.
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

}  // namespace route
