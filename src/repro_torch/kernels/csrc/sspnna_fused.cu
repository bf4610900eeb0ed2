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
// What bounds it on the card: per pair it does 2*C*N FLOPs; counting each
// input row, weight and table word once, the SCN convs sit around the
// H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20 FLOP per byte): the
// narrow level-0 convs are bound by bytes, chiefly the int32 local_idx
// table (T*dO*K words), the wider ones by fp32 operations. What keeps a
// simple kernel from either bound is the chain of dependent loads from a
// slot to its partner row (local_idx, in_rows, feats) on every plane.
//
// What the design does about that: the TPU kernel turns the gather into a
// one-hot partial-permutation matmul because TPU VMEM has no gather port;
// here partner rows are read directly, so no one-hot operand exists and no
// MACs are spent on it. Each block owns one (tile, chunk of slots) and all
// N output channels, so a partner row is read once per block. It first
// resolves every (slot, plane) of its chunk to a global row into shared
// memory with coalesced table reads, leaving one load (feats) per pair in
// the plane loop. Per plane it stages the (C, N) weight slab in shared
// memory; a thread owns kSlots slots times 4 adjacent channels, and reads
// a partner row 4 channels at a time (float4) where C allows, so one
// loaded float feeds 4 FMAs. The chunk is sized from dO so that no slot
// lane idles (dO=32: 32 lanes, one slot each). Staging the tile's working
// set with cp.async/TMA and feeding wgmma is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ void fma4(float4& acc, float x, const float4& w) {
  acc.x = fmaf(x, w.x, acc.x);
  acc.y = fmaf(x, w.y, acc.y);
  acc.z = fmaf(x, w.z, acc.z);
  acc.w = fmaf(x, w.w, acc.w);
}

// Block: `quads * lanes` threads, thread = (slot lane, 4-channel quad).
// Shared memory: the plane's weight slab (c, quads) float4, then the
// chunk's partner rows (chunk, k_planes) int32 (-1 = hole).
template <int kSlots, bool kVec4>
__global__ void __launch_bounds__(kMaxThreads)
sspnna_fused_kernel(const float* __restrict__ feats,
                    const float* __restrict__ weights,
                    const int32_t* __restrict__ out_rows,
                    const int32_t* __restrict__ in_rows,
                    const int32_t* __restrict__ local_idx,
                    const int32_t* __restrict__ pair_counts,
                    float* __restrict__ out,
                    int d_o, int d_i, int k_planes, int c, int n, int n_out,
                    int lanes) {
  const int t = blockIdx.x;
  if (pair_counts[t] <= 0) return;  // dead tile: uniform over the block
  const int quads = (n + 3) / 4;
  const int q = threadIdx.x % quads;      // output channels 4q .. 4q+3
  const int lane = threadIdx.x / quads;   // slot lane
  const int o0 = blockIdx.y * lanes * kSlots;
  const int n_slots = min(lanes * kSlots, d_o - o0);

  extern __shared__ float4 smem[];
  float4* w_slab = smem;
  int* partner = reinterpret_cast<int*>(smem + c * quads);

  const int32_t* chunk_idx = local_idx + ((int64_t)t * d_o + o0) * k_planes;
  const int32_t* tile_in = in_rows + (int64_t)t * d_i;
  for (int e = threadIdx.x; e < n_slots * k_planes; e += blockDim.x) {
    const int li = chunk_idx[e];
    partner[e] = li < 0 ? -1 : max(tile_in[li], 0);  // raw-layout pads read row 0
  }

  float4 acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);

  float* slab = reinterpret_cast<float*>(w_slab);
  const int width = quads * 4;
  for (int k = 0; k < k_planes; ++k) {
    __syncthreads();  // partners written / previous slab consumed
    const float* wk = weights + (int64_t)k * c * n;
    for (int e = threadIdx.x; e < c * width; e += blockDim.x) {
      const int cc = e / width;
      const int nn = e % width;
      slab[e] = nn < n ? wk[(int64_t)cc * n + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int o = lane + s * lanes;
      if (o >= n_slots) continue;
      const int row = partner[o * k_planes + k];
      if (row < 0) continue;  // hole: no partner on this plane
      const float* f = feats + (int64_t)row * c;
      if constexpr (kVec4) {
        for (int cc = 0; cc < c; cc += 4) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(f + cc));
          fma4(acc[s], x.x, w_slab[(cc + 0) * quads + q]);
          fma4(acc[s], x.y, w_slab[(cc + 1) * quads + q]);
          fma4(acc[s], x.z, w_slab[(cc + 2) * quads + q]);
          fma4(acc[s], x.w, w_slab[(cc + 3) * quads + q]);
        }
      } else {
        for (int cc = 0; cc < c; ++cc)
          fma4(acc[s], __ldg(f + cc), w_slab[cc * quads + q]);
      }
    }
  }

  const int col = 4 * q;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int o = lane + s * lanes;
    if (o >= n_slots) continue;
    int r = out_rows[(int64_t)t * d_o + o0 + o];
    if (r < 0) r = n_out;  // raw-layout pad -> trash row
    float* dst = out + (int64_t)r * n + col;
    const float v[4] = {acc[s].x, acc[s].y, acc[s].z, acc[s].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < n) dst[j] = v[j];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() as an int (0 = success).
// `out` is the caller's zeroed (n_out + 1, n) buffer; row n_out is trash.
int sspnna_fused_f32(const float* feats, const float* weights,
                     const int32_t* out_rows, const int32_t* in_rows,
                     const int32_t* local_idx, const int32_t* pair_counts,
                     float* out, int n_tiles, int d_o, int d_i, int k_planes,
                     int c, int n, int n_out, void* stream) {
  const int quads = (n + 3) / 4;
  if (quads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int max_lanes = kMaxThreads / quads;
  // two slots a thread only where dO fills two full blocks' worth of lanes
  const int slots = d_o >= 2 * max_lanes ? 2 : 1;
  const int want = (d_o + slots - 1) / slots;
  const int lanes = want < max_lanes ? want : max_lanes;
  const int chunk = lanes * slots;
  const size_t smem = (size_t)c * quads * sizeof(float4) +
                      (size_t)chunk * k_planes * sizeof(int32_t);
  const bool vec4 = c % 4 == 0 && (uintptr_t)feats % sizeof(float4) == 0;
  auto kernel = slots == 2
      ? (vec4 ? sspnna_fused_kernel<2, true> : sspnna_fused_kernel<2, false>)
      : (vec4 ? sspnna_fused_kernel<1, true> : sspnna_fused_kernel<1, false>);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_tiles, (d_o + chunk - 1) / chunk);
  kernel<<<grid, quads * lanes, smem, (cudaStream_t)stream>>>(
      feats, weights, out_rows, in_rows, local_idx, pair_counts, out, d_o,
      d_i, k_planes, c, n, n_out, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
