// Grouped expert GEMM for Hopper, f32 or bf16 inputs.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/moe_gemm/moe_gemm.py
// (entry `grouped_gemm`). For each expert e of E it computes
//
//   out[e, r, :] = (valid[e, r] ? x[e, r, :] : 0) @ w[e]      (f32 sums)
//
// with x (E, C, d), w (E, d, f), valid (E, C) bytes (a torch bool tensor)
// and out (E, C, f), all contiguous; out is f32 or bf16, whatever the
// inputs. C, d and f need not divide the tiles: the ragged edges are
// zero-filled on load and masked on store. Rows that are not valid come out
// as exact zeros.
//
// What bounds it on the card. Prefill (C ~ 1,000 capacity slots of 2048 or
// 1408 wide rows per expert) does ~1,000 FLOPs per byte of w, x and out,
// above the ~295 at which the bf16 tensor cores (989 TFLOP/s) outrun the
// 3.35 TB/s: it is bound by operations. Decode (C = 8) does 2 FLOPs per
// byte of w: it is bound by reading w, and only the experts that some token
// was routed to need to be read.
//
// What the design does about that. The TPU kernel holds one expert's whole
// (C, d) block and one (d, bf) slab of w in VMEM and runs one MXU product
// per grid step. Here one block computes a 64 x 64 tile of one expert's
// output (grid: f tiles, C tiles, experts), staging 64 x 32 of x and
// 32 x 64 of w per step in shared memory. bf16 inputs run on the tensor
// cores (WMMA 16 x 16 x 16 fragments, f32 accumulators: each of 4 warps
// owns 32 x 32 of the tile); f32 inputs run on the CUDA cores (each of 256
// threads owns 4 x 4 outputs, f32 FMAs). Loads are 16 bytes a thread where
// d, f and the bases allow, else one element. A tile whose 64 rows are all
// invalid (capacity padding; in decode every expert no token chose) writes
// its zeros and never reads w, so the bytes a decode step reads follow the
// routing, not E. cp.async/TMA pipelining, wgmma and larger tiles are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;   // rows (capacity slots) of a tile
constexpr int kBN = 64;   // output columns of a tile

// tensor-core path (bf16 inputs)
constexpr int kBK = 32;              // depth of a staged step
constexpr int kThreadsTC = 128;      // 4 warps, 32 x 32 outputs each
constexpr int kLdA = kBK + 8;        // row pitches, multiples of 8 halves
constexpr int kLdB = kBN + 8;        // (WMMA) that spread shared banks
constexpr int kLdC = kBN + 4;

// CUDA-core path (f32 inputs)
constexpr int kBKS = 16;             // depth of a staged step
constexpr int kThreadsS = 256;       // 16 x 16 threads, 4 x 4 outputs each

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// Loads the validity of the tile's rows into vs (0 past C) and tells every
// thread whether any row is valid. Needs blockDim.x >= kBM.
__device__ __forceinline__ bool stage_valid(uint8_t* vs,
                                            const uint8_t* __restrict__ valid_e,
                                            int m0, int c) {
  int live = 0;
  if (threadIdx.x < kBM) {
    const int m = m0 + threadIdx.x;
    const uint8_t v = m < c ? valid_e[m] : 0;
    vs[threadIdx.x] = v;
    live = v != 0;
  }
  return __syncthreads_or(live) != 0;
}

template <typename OutT>
__device__ void store_zeros(OutT* __restrict__ out_e, int m0, int n0, int c,
                            int f) {
  for (int i = threadIdx.x; i < kBM * kBN; i += blockDim.x) {
    const int m = m0 + i / kBN, n = n0 + i % kBN;
    if (m < c && n < f) out_e[(long)m * f + n] = from_f32<OutT>(0.f);
  }
}

// bf16 inputs: tensor cores. kVec: d and f are multiples of 8 and x, w are
// 16-byte aligned, so a thread loads 8 elements at once.
template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreadsTC)
moe_gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const uint8_t* __restrict__ valid, OutT* __restrict__ out,
                     int c, int d, int f) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 as[kBM * kLdA];
  __shared__ __align__(128) bf16 bs[kBK * kLdB];
  __shared__ __align__(128) float cs[kBM * kLdC];
  __shared__ uint8_t vs[kBM];

  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  OutT* out_e = out + (long)e * c * f;
  if (!stage_valid(vs, valid + (long)e * c, m0, c)) {
    store_zeros(out_e, m0, n0, c, f);
    return;
  }
  const bf16* x_e = x + (long)e * c * d;
  const bf16* w_e = w + (long)e * d * f;
  const bf16 zero = __float2bfloat16(0.f);
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // x tile (kBM x kBK): invalid rows and columns past d as zeros
    if (kVec) {
      for (int i = threadIdx.x; i < kBM * kBK / 8; i += kThreadsTC) {
        const int r = i / (kBK / 8), col = (i % (kBK / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (vs[r] && k0 + col < d)
          v = *reinterpret_cast<const uint4*>(x_e + (long)(m0 + r) * d + k0 +
                                              col);
        *reinterpret_cast<uint4*>(as + r * kLdA + col) = v;
      }
      for (int i = threadIdx.x; i < kBK * kBN / 8; i += kThreadsTC) {
        const int r = i / (kBN / 8), col = (i % (kBN / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k0 + r < d && n0 + col < f)
          v = *reinterpret_cast<const uint4*>(w_e + (long)(k0 + r) * f + n0 +
                                              col);
        *reinterpret_cast<uint4*>(bs + r * kLdB + col) = v;
      }
    } else {
      for (int i = threadIdx.x; i < kBM * kBK; i += kThreadsTC) {
        const int r = i / kBK, col = i % kBK;
        as[r * kLdA + col] = (vs[r] && k0 + col < d)
                                 ? x_e[(long)(m0 + r) * d + k0 + col]
                                 : zero;
      }
      for (int i = threadIdx.x; i < kBK * kBN; i += kThreadsTC) {
        const int r = i / kBN, col = i % kBN;
        bs[r * kLdB + col] = (k0 + r < d && n0 + col < f)
                                 ? w_e[(long)(k0 + r) * f + n0 + col]
                                 : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (wm + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * kLdB + wn + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * kLdC + wn + 16 * j,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreadsTC) {
    const int r = i / kBN, col = i % kBN;
    const int m = m0 + r, n = n0 + col;
    if (m < c && n < f)
      out_e[(long)m * f + n] = from_f32<OutT>(vs[r] ? cs[r * kLdC + col] : 0.f);
  }
}

// f32 inputs: CUDA cores, thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of the tile, so a warp's shared reads are broadcasts or
// consecutive words and its stores are coalesced.
template <typename OutT>
__global__ void __launch_bounds__(kThreadsS)
moe_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const uint8_t* __restrict__ valid, OutT* __restrict__ out,
                    int c, int d, int f) {
  __shared__ float as[kBKS][kBM + 4];   // x tile transposed: as[k][row]
  __shared__ float bs[kBKS][kBN];
  __shared__ uint8_t vs[kBM];

  const int e = blockIdx.z, m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  OutT* out_e = out + (long)e * c * f;
  if (!stage_valid(vs, valid + (long)e * c, m0, c)) {
    store_zeros(out_e, m0, n0, c, f);
    return;
  }
  const float* x_e = x + (long)e * c * d;
  const float* w_e = w + (long)e * d * f;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < d; k0 += kBKS) {
    for (int i = threadIdx.x; i < kBM * kBKS; i += kThreadsS) {
      const int r = i / kBKS, col = i % kBKS;
      as[col][r] = (vs[r] && k0 + col < d) ? x_e[(long)(m0 + r) * d + k0 + col]
                                           : 0.f;
    }
    for (int i = threadIdx.x; i < kBKS * kBN; i += kThreadsS) {
      const int r = i / kBN, col = i % kBN;
      bs[r][col] = (k0 + r < d && n0 + col < f)
                       ? w_e[(long)(k0 + r) * f + n0 + col]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKS; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, m = m0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < c && n < f)
        out_e[(long)m * f + n] = from_f32<OutT>(vs[r] ? acc[i][j] : 0.f);
    }
  }
}

template <typename OutT>
int launch_bf16(const void* x, const void* w, const uint8_t* valid, void* out,
                int e, int c, int d, int f, cudaStream_t stream) {
  const dim3 grid((f + kBN - 1) / kBN, (c + kBM - 1) / kBM, e);
  const bool vec = d % 8 == 0 && f % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  OutT* o = static_cast<OutT*>(out);
  if (vec)
    moe_gemm_bf16_kernel<OutT, true>
        <<<grid, kThreadsTC, 0, stream>>>(xb, wb, valid, o, c, d, f);
  else
    moe_gemm_bf16_kernel<OutT, false>
        <<<grid, kThreadsTC, 0, stream>>>(xb, wb, valid, o, c, d, f);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_f32(const void* x, const void* w, const uint8_t* valid, void* out,
               int e, int c, int d, int f, cudaStream_t stream) {
  const dim3 grid((f + kBN - 1) / kBN, (c + kBM - 1) / kBM, e);
  moe_gemm_f32_kernel<OutT><<<grid, kThreadsS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), valid,
      static_cast<OutT*>(out), c, d, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() as an int (0 = success).
// dtype is that of x and w, out_dtype that of out: 0 = float32,
// 1 = bfloat16. valid holds one byte (0 or 1) per row.
int moe_gemm(const void* x, const void* w, const void* valid, void* out,
             int dtype, int out_dtype, int e, int c, int d, int f,
             void* stream) {
  if (e <= 0 || c <= 0 || d < 0 || f <= 0 || e > 65535 ||
      (c + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  if (dtype == 1 && out_dtype == 0)
    return launch_bf16<float>(x, w, v, out, e, c, d, f, s);
  if (dtype == 1 && out_dtype == 1)
    return launch_bf16<bf16>(x, w, v, out, e, c, d, f, s);
  if (dtype == 0 && out_dtype == 0)
    return launch_f32<float>(x, w, v, out, e, c, d, f, s);
  if (dtype == 0 && out_dtype == 1)
    return launch_f32<bf16>(x, w, v, out, e, c, d, f, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
