// Flash-attention forward (online softmax) for Hopper, f32 or bf16 inputs.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/flash/flash.py
// (entry `flash_attention`, GQA fold in flash/ops.py). For query row i of
// head h it computes, with q rows right-aligned on the kv sequence
// (q_pos = skv - sq + i) and G = hq / hkv query heads per kv head:
//
//   s[j] = (q[i,h] . k[j,h/G]) * d^-1/2                 (f32 sums)
//   s[j] = cap * tanh(s[j] / cap)                       (softcap, if any)
//   s[j] = -1e30 where j > q_pos (causal) or j <= q_pos - window
//   out[i,h] = sum_j p[j] v[j,h/G] / max(sum_j p[j], 1e-30),
//   p[j] = exp(s[j] - max s), 0 where masked; p is rounded to v's type
//   before the PV product, and a fully masked row gives 0.
//
// Layout: q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), out like q, all
// contiguous. GQA is folded by indexing kv head h / G, so k and v are never
// repeated. D is 32, 64, 128 or 256; the ragged edges of Sq and Skv are
// masked here, so neither must divide the tile.
//
// What bounds it on the card: 4*D FLOPs per unmasked (q, k) pair against
// one read of Q, K, V and one write of O. At the Gemma-2 prefill shapes
// (S = 6144, D = 256) that is ~2,000 FLOP per byte, far above the ~295 at
// which the bf16 tensor cores (989 TFLOP/s) stop outrunning the 3.35 TB/s,
// so even a tensor-core kernel would be bound by operations.
// This kernel multiplies on the CUDA cores in f32 (67 TFLOP/s peak), so the
// FMA rate, and the shared-memory reads that feed it, bound it.
//
// What the design does about that: the TPU kernel sweeps every kv block of
// its grid and masks; here a block (64 query rows of one head) walks only
// the kv tiles its rows can see (causal end, window start), so masked
// tiles cost nothing, and the heaviest causal blocks are scheduled first.
// Q and each K/V tile are staged once in shared memory as f32 (rows padded
// by one float so a warp's row reads fall in distinct banks); a thread
// owns 4 query rows times D/16 output columns, keeps the running max, sum
// and accumulator in registers, and reduces row statistics with warp
// shuffles across the 16 threads of a row group. Tensor cores (mma/wgmma),
// TMA and double-buffered tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 row groups x 16 column lanes
constexpr int kBQ = 64;         // query rows of a block (4 per row group)
constexpr int kBK = 64;         // kv rows of a tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // q (kBQ x D+1), k (kBK x D+1), v (kBK x D), p (kBQ x kBK+1), f32
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kBQ * (kBK + 1));
}

// Stage `rows` rows of D elements (row r at src + r * stride) in shared
// memory as f32 with leading dimension ld; rows >= n_valid become 0.
// 16-byte loads: D is a multiple of 32 and the base is 16-byte aligned.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const T* __restrict__ src, long stride,
                                      int rows, int n_valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float* out = dst + r * ld + c;
    if (r < n_valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = 0.f;
    }
  }
}

__device__ __forceinline__ float row_group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Grid (ceil(sq / kBQ), hq, b). Thread (tr, tc) = (tid / 16, tid % 16) owns
// query rows 4*tr .. 4*tr+3 of the block; within a tile it scores kv rows
// tc + 16*j and accumulates output columns tc + 16*j.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, int hq, int hkv, float scale, int causal,
                 int window, float softcap) {
  constexpr int kLdQ = D + 1, kLdV = D, kLdP = kBK + 1;
  constexpr int kSC = kBK / 16;   // score columns per thread
  constexpr int kOC = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * kLdQ;
  float* vs = ks + kBK * kLdQ;
  float* ps = vs + kBK * kLdV;

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  // heaviest causal blocks (last query rows) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (hq / hkv);
  const int offset = skv - sq;   // absolute position of query row 0
  const long q_stride = (long)hq * D, kv_stride = (long)hkv * D;
  const T* qb = q + ((long)b * sq + q0) * q_stride + (long)h * D;
  const T* kb = k + (long)b * skv * kv_stride + (long)kh * D;
  const T* vb = v + (long)b * skv * kv_stride + (long)kh * D;

  const int n_q = min(kBQ, sq - q0);
  stage<T, D>(qs, kLdQ, qb, q_stride, kBQ, n_q);

  // the kv tiles any row of this block can see
  const int pos_lo = offset + q0, pos_hi = offset + q0 + n_q - 1;
  const int kv_end = causal ? min(skv, pos_hi + 1) : skv;
  const int kv_begin = window > 0 ? max(0, pos_lo - window + 1) / kBK * kBK : 0;

  float acc[4][kOC];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    const int n_k = min(kBK, skv - kv0);
    stage<T, D>(ks, kLdQ, kb + kv0 * kv_stride, kv_stride, kBK, n_k);
    stage<T, D>(vs, kLdV, vb + kv0 * kv_stride, kv_stride, kBK, n_k);
    __syncthreads();

    float s[4][kSC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kSC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[kSC];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * tr + i) * kLdQ + d];
#pragma unroll
      for (int j = 0; j < kSC; ++j) kv[j] = ks[(tc + 16 * j) * kLdQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kSC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = offset + q0 + 4 * tr + i;
      bool live[kSC];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSC; ++j) {
        const int k_pos = kv0 + tc + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        live[j] = k_pos < skv && (!causal || k_pos <= q_pos) &&
                  (window <= 0 || k_pos > q_pos - window);
        s[i][j] = live[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_group_max(mx));
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSC; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(4 * tr + i) * kLdP + tc + 16 * j] = to_f32(from_f32<T>(p));
      }
      l_run[i] = l_run[i] * alpha + row_group_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[kOC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * tr + i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kOC; ++c) vv[c] = vs[j * kLdV + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kOC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= sq) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    T* o = out + ((long)b * sq + row) * q_stride + (long)h * D;
#pragma unroll
    for (int c = 0; c < kOC; ++c) o[tc + 16 * c] = from_f32<T>(acc[i][c] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int hq, int hkv, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, hq, hkv, scale,
      causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             int b, int sq, int skv, int hq, int hkv, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                                  window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                                  window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                                    window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                                    window, softcap, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() as an int (0 = success).
// dtype 0 = float32, 1 = bfloat16 (q, k, v and out share it). window <= 0
// means no window, softcap <= 0 no softcap; scale is d^-1/2.
int flash_fwd(const void* q, const void* k, const void* v, void* out,
              int dtype, int b, int sq, int skv, int hq, int hkv, int d,
              int causal, int window, float softcap, float scale,
              void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, out, b, sq, skv, hq, hkv, causal,
                           window, softcap, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, out, b, sq, skv, hq, hkv,
                                   causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
