// Fused SSpNNA sparse convolution (gather-GEMM-scatter) for Hopper, fp32.
//
// Replaces the TPU kernel `_fused_kernel` of
// src/repro/kernels/sspnna/sspnna.py (entry `sspnna_fused`). For every live
// tile t (pair_counts[t] > 0) and output slot o it computes
//
//   out[out_rows[t, o], :] = sum_k feats[in_rows[t, local_idx[t, o, k]], :] @ W[k]
//
// with f32 accumulation; a -1 in local_idx is a hole and adds nothing, an
// output pad (out_rows < 0 or == n_out) lands on the trash row n_out, and a
// dead tile leaves its rows at the caller's zero initial value. Tiles own
// disjoint output rows, so every output element is written by exactly one
// thread and no atomics are needed.
//
// What bounds it at the SCN's shapes: per pair 2*C*N FLOPs, against each
// referenced input row, W, the tables (chiefly local_idx, T*dO*K int32)
// read once and the output written once. Over a forward that is 0.23 ms
// on the H100 at the fp32 peak (67 TFLOP/s; levels 1-2 by operations,
// 0 and 3 by bytes). On the tensor cores in 3xTF32 the operations bound
// is 67 / (495 / 3) = 0.41x of that, so bytes weigh more.
//
// The design it replaces (one block a tile chunk, a thread a slot times 4
// channels, FMAs) ran ~20x off that bound, and sspnna_tile.cuh answers
// each cause:
// 1. One 16-byte shared-memory load fed four FMAs: the products run on
//    the tensor cores (mma.sync, 3xTF32), each fragment load feeding a
//    16x8x8 product.
// 2. Nothing was in flight while the FMAs ran (two barriers, a synchronous
//    weight copy and a dependent partner->row chain a plane): partners
//    are resolved once, and both operands of the next planes are copied
//    by cp.async into a ring of stages while this plane's products run,
//    with one barrier a plane.
// 3. Holes idled their threads: a hole is a zero-filled copy and a zero
//    row of the product, so no lane diverges, and a plane on which no row
//    of the block has a partner is skipped by the whole block.
// 4. Too few warps where tiles are few: a block owns 32-128 consecutive
//    (tile, slot) rows across tiles and a slice of N, both chosen from T,
//    dO and N so each level keeps about two blocks an SM busy.

#include "sspnna_tile.cuh"

namespace {

// Partner rows from the global features through in_rows, looked up by an
// asynchronous copy (raw-layout pads, -1, read row 0); outputs to
// out_rows, pads to the trash row n_out, and nothing for a dead tile.
struct FusedRows {
  const int32_t* in_rows;
  const int32_t* out_rows;
  const int32_t* pair_counts;
  int d_i, n_out;

  __device__ void resolve(int* dst, int t, int li) const {
    sspnna::cp_async_4(dst, in_rows + (int64_t)t * d_i + li, true);
  }
  __device__ int dest(int r, int d_o) const {
    if (__ldg(pair_counts + r / d_o) <= 0) return -1;
    const int o = __ldg(out_rows + r);
    return o < 0 ? n_out : o;
  }
};

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() as an int (0 = success).
// `out` is the caller's zeroed (n_out + 1, n) buffer; row n_out is trash.
int sspnna_fused_f32(const float* feats, const float* weights,
                     const int32_t* out_rows, const int32_t* in_rows,
                     const int32_t* local_idx, const int32_t* pair_counts,
                     float* out, int n_tiles, int d_o, int d_i, int k_planes,
                     int c, int n, int n_out, void* stream) {
  const FusedRows rows{in_rows, out_rows, pair_counts, d_i, n_out};
  return sspnna::launch<float>(rows, feats, weights, local_idx, out, n_tiles,
                               d_o, d_i, k_planes, c, n,
                               static_cast<cudaStream_t>(stream));
}

// The launch's shape, as sspnna::describe gives it (8 ints).
int sspnna_fused_geometry(int n_tiles, int d_o, int k_planes, int c, int n,
                          int* shape) {
  return sspnna::describe<float, FusedRows>(n_tiles, d_o, k_planes, c, n,
                                            shape);
}

}  // extern "C"
