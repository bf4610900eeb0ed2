// SSpNNA over a pre-gathered stack of tiles, for Hopper, f32 or bf16.
//
// Replaces the TPU kernel `_pregathered_kernel` of
// src/repro/kernels/sspnna/sspnna.py (entry `sspnna_tiles`). For every tile
// t and output slot o it computes
//
//   out[t, o, :] = sum_k feats[t, local_idx[t, o, k], :] @ W[k]
//
// with feats (T, dI, C), local_idx (T, dO, K) int32, W (K, C, N) and out
// (T, dO, N), all contiguous, feats, W and out of one dtype (f32 or bf16).
// Sums are f32; the output is rounded to the input dtype. A -1 in
// local_idx is a hole and adds nothing (an index outside [-1, dI) is
// outside the contract and is read as a hole too, so no load leaves the
// tile's slab). Every output element is written: rows whose partners are
// all holes (a dead tile of a padded plan) get zeros.
//
// What bounds it at the SCN's shapes: per pair 2*C*N FLOPs, against the
// referenced rows of the stack, W and local_idx read once and (T, dO, N)
// written once: 0.23 ms over a forward's 15 convs at the H100's fp32 peak
// (67 TFLOP/s), operations in sum; on the tensor cores (f32 as 3xTF32 at
// 495 / 3 TFLOP/s) the operations bound is 0.41x of that.
//
// The design it replaces was the fused kernel's, copied, and ran ~20x off
// that bound; both kernels now share the tile body of sspnna_tile.cuh,
// with slab row t * dI + li in place of a global row, so they sum in the
// same order and a pre-gathered conv equals the fused one bit for bit.
// What it does about each cause:
// 1. One 16-byte shared-memory load fed four FMAs: tensor cores
//    (mma.sync: bf16 m16n8k16, f32 as 3xTF32 on m16n8k8).
// 2. Nothing was in flight while the FMAs ran: partners resolved once,
//    both operands fed by cp.async through a ring of plane stages, one
//    barrier a plane.
// 3. Holes idled their threads: zero-filled copies and zero product
//    rows, and planes with no partner in the block skipped block-wide.
// 4. Too few warps where tiles are few: blocks of 32-128 rows across
//    tiles and a slice of N, sized from T, dO and N.

#include "sspnna_tile.cuh"

namespace {

// Partner rows in the tile's own (dI, C) slab; outputs to the (t, o) slot.
struct StackRows {
  int d_i;

  __device__ void resolve(int* dst, int t, int li) const {
    *dst = t * d_i + li;
  }
  __device__ int dest(int r, int) const { return r; }
};

template <typename T>
int run(const void* feats, const void* local_idx, const void* weights,
        void* out, int n_tiles, int d_i, int d_o, int k_planes, int c, int n,
        void* stream) {
  if ((int64_t)n_tiles * d_i >= INT32_MAX) return (int)cudaErrorInvalidValue;
  return sspnna::launch<T>(
      StackRows{d_i}, static_cast<const T*>(feats),
      static_cast<const T*>(weights), static_cast<const int32_t*>(local_idx),
      static_cast<T*>(out), n_tiles, d_o, d_i, k_planes, c, n,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() as an int (0 = success).
// dtype is that of feats, weights and out: 0 = float32, 1 = bfloat16.
// `out` (n_tiles, d_o, n) needs no initial value: every element is written.
int sspnna_tiles(const void* feats, const void* local_idx,
                 const void* weights, void* out, int dtype, int n_tiles,
                 int d_i, int d_o, int k_planes, int c, int n, void* stream) {
  if (dtype == 0)
    return run<float>(feats, local_idx, weights, out, n_tiles, d_i, d_o,
                      k_planes, c, n, stream);
  if (dtype == 1)
    return run<sspnna::bf16>(feats, local_idx, weights, out, n_tiles, d_i,
                             d_o, k_planes, c, n, stream);
  return (int)cudaErrorInvalidValue;
}

// The launch's shape, as sspnna::describe gives it (8 ints).
int sspnna_tiles_geometry(int n_tiles, int d_o, int k_planes, int c, int n,
                          int dtype, int* shape) {
  if (dtype == 0)
    return sspnna::describe<float, StackRows>(n_tiles, d_o, k_planes, c, n,
                                              shape);
  if (dtype == 1)
    return sspnna::describe<sspnna::bf16, StackRows>(n_tiles, d_o, k_planes,
                                                     c, n, shape);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
