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
// tile's slab). Every output element is written: a chunk of slots whose
// partners are all holes (a dead tile of a padded plan) writes zeros and
// never reads its weights.
//
// What bounds it on the card: per pair it does 2*C*N FLOPs, and it must
// read the (T, dI, C) stack, W and local_idx once and write (T, dO, N)
// once. At the SCN's widths (C, N 4-128) that is ~10-40 FLOPs per byte,
// around the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20 FLOPs per
// byte): the narrow convs are bound by bytes, chiefly the int32 local_idx
// (T*dO*K words) and the padded stack, the wide ones by fp32 operations.
//
// What the design does about that. The TPU kernel gathers each tile's
// partners with a one-hot partial-permutation matmul because TPU VMEM has
// no gather port; here partner rows are read directly from the tile's
// (dI, C) slab, so no one-hot operand exists and no MACs are spent on it.
// The design is the fused kernel's (sspnna_fused.cu), with the slab in
// place of the global rows: one block owns one (tile, chunk of slots) and
// all N output channels, so a partner row is read once per block. It
// first copies its chunk's (slot, plane) partner indices into shared
// memory with coalesced reads, then per plane stages the (C, N) weight
// slab in shared memory (converted to f32); a thread owns kSlots slots
// times 4 adjacent channels and reads a partner row 4 channels at a time
// (16 bytes in f32, 8 in bf16) where C and the base allow, so one loaded
// value feeds 4 FMAs. Staging the slab with cp.async/TMA and tensor-core
// products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;

__device__ __forceinline__ void fma4(float4& acc, float x, const float4& w) {
  acc.x = fmaf(x, w.x, acc.x);
  acc.y = fmaf(x, w.y, acc.y);
  acc.z = fmaf(x, w.z, acc.z);
  acc.w = fmaf(x, w.w, acc.w);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16* p) {
  return __bfloat162float(*p);
}

// Four consecutive values; p is 16-byte (f32) or 8-byte (bf16) aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  // a bf16 is the high half of the f32 with the same bits (little endian:
  // element 0 is the low half of the first word)
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Block: `quads * lanes` threads, thread = (slot lane, 4-channel quad).
// Shared memory: the plane's weight slab (c, quads) float4, then the
// chunk's partner indices (chunk, k_planes) int32 (-1 = hole).
template <typename T, int kSlots, bool kVec4>
__global__ void __launch_bounds__(kMaxThreads)
sspnna_tiles_kernel(const T* __restrict__ feats,
                    const int32_t* __restrict__ local_idx,
                    const T* __restrict__ weights, T* __restrict__ out,
                    int d_i, int d_o, int k_planes, int c, int n, int lanes) {
  const int t = blockIdx.x;
  const int quads = (n + 3) / 4;
  const int q = threadIdx.x % quads;      // output channels 4q .. 4q+3
  const int lane = threadIdx.x / quads;   // slot lane
  const int o0 = blockIdx.y * lanes * kSlots;
  const int n_slots = min(lanes * kSlots, d_o - o0);

  extern __shared__ float4 smem[];
  float4* w_slab = smem;
  int* partner = reinterpret_cast<int*>(smem + c * quads);

  const int32_t* chunk_idx = local_idx + ((int64_t)t * d_o + o0) * k_planes;
  int any = 0;
  for (int e = threadIdx.x; e < n_slots * k_planes; e += blockDim.x) {
    const int li = chunk_idx[e];
    const int p = (li >= 0 && li < d_i) ? li : -1;
    partner[e] = p;
    any |= p >= 0;
  }
  // uniform over the block: an all-hole chunk skips the plane loop
  const bool live = __syncthreads_or(any) != 0;

  float4 acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);

  const T* slab_in = feats + (int64_t)t * d_i * c;
  float* slab = reinterpret_cast<float*>(w_slab);
  const int width = quads * 4;
  for (int k = 0; live && k < k_planes; ++k) {
    if (k > 0) __syncthreads();  // previous slab consumed
    const T* wk = weights + (int64_t)k * c * n;
    for (int e = threadIdx.x; e < c * width; e += blockDim.x) {
      const int cc = e / width;
      const int nn = e % width;
      slab[e] = nn < n ? load1(wk + (int64_t)cc * n + nn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int o = lane + s * lanes;
      if (o >= n_slots) continue;
      const int row = partner[o * k_planes + k];
      if (row < 0) continue;  // hole: no partner on this plane
      const T* f = slab_in + (int64_t)row * c;
      if constexpr (kVec4) {
        for (int cc = 0; cc < c; cc += 4) {
          const float4 x = load4(f + cc);
          fma4(acc[s], x.x, w_slab[(cc + 0) * quads + q]);
          fma4(acc[s], x.y, w_slab[(cc + 1) * quads + q]);
          fma4(acc[s], x.z, w_slab[(cc + 2) * quads + q]);
          fma4(acc[s], x.w, w_slab[(cc + 3) * quads + q]);
        }
      } else {
        for (int cc = 0; cc < c; ++cc)
          fma4(acc[s], load1(f + cc), w_slab[cc * quads + q]);
      }
    }
  }

  const int col = 4 * q;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int o = lane + s * lanes;
    if (o >= n_slots) continue;
    T* dst = out + ((int64_t)t * d_o + o0 + o) * n + col;
    const float v[4] = {acc[s].x, acc[s].y, acc[s].z, acc[s].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < n) store1(dst + j, v[j]);
  }
}

template <typename T>
int launch(const T* feats, const int32_t* local_idx, const T* weights,
           T* out, int n_tiles, int d_i, int d_o, int k_planes, int c, int n,
           cudaStream_t stream) {
  const int quads = (n + 3) / 4;
  if (quads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int max_lanes = kMaxThreads / quads;
  // two slots a thread only where dO fills two full blocks' worth of lanes
  const int slots = d_o >= 2 * max_lanes ? 2 : 1;
  const int want = (d_o + slots - 1) / slots;
  const int lanes = want < max_lanes ? want : max_lanes;
  const int chunk = lanes * slots;
  const int chunks = (d_o + chunk - 1) / chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)c * quads * sizeof(float4) +
                      (size_t)chunk * k_planes * sizeof(int32_t);
  const bool vec4 =
      c % 4 == 0 && (uintptr_t)feats % (4 * sizeof(T)) == 0;
  auto kernel = slots == 2
      ? (vec4 ? sspnna_tiles_kernel<T, 2, true>
              : sspnna_tiles_kernel<T, 2, false>)
      : (vec4 ? sspnna_tiles_kernel<T, 1, true>
              : sspnna_tiles_kernel<T, 1, false>);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_tiles, chunks);
  kernel<<<grid, quads * lanes, smem, stream>>>(
      feats, local_idx, weights, out, d_i, d_o, k_planes, c, n, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() as an int (0 = success).
// dtype is that of feats, weights and out: 0 = float32, 1 = bfloat16.
// `out` (n_tiles, d_o, n) needs no initial value: every element is written.
int sspnna_tiles(const void* feats, const void* local_idx,
                 const void* weights, void* out, int dtype, int n_tiles,
                 int d_i, int d_o, int k_planes, int c, int n, void* stream) {
  if (n_tiles <= 0 || d_i < 0 || d_o <= 0 || k_planes < 0 || c < 0 ||
      n <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idx = static_cast<const int32_t*>(local_idx);
  if (dtype == 0)
    return launch<float>(static_cast<const float*>(feats), idx,
                         static_cast<const float*>(weights),
                         static_cast<float*>(out), n_tiles, d_i, d_o,
                         k_planes, c, n, s);
  if (dtype == 1)
    return launch<bf16>(static_cast<const bf16*>(feats), idx,
                        static_cast<const bf16*>(weights),
                        static_cast<bf16*>(out), n_tiles, d_i, d_o,
                        k_planes, c, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
