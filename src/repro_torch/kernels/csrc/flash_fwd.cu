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
// contiguous and 16-byte aligned. GQA is folded by indexing kv head h / G,
// so k and v are never repeated. D is 32, 64, 128 or 256; the ragged edges
// of Sq and Skv are masked here, so neither must divide the tile.
//
// What bounds it on the card: 4*D FLOPs per unmasked (q, k) pair against
// one read of Q, K, V and one write of O. At the Gemma-2 prefill shapes
// (S = 6144, D = 256) that is ~2,000 FLOP per byte, far above the ~295 at
// which the bf16 tensor cores (989 TFLOP/s) stop outrunning the 3.35 TB/s,
// so the tensor cores' rate bounds it.
//
// What the design does about that. Both kernels walk, per block, only the
// kv tiles its rows can see (causal end, window start), so masked tiles
// cost nothing, and schedule the heaviest causal blocks first.
//
// * bf16 (the served LMs' path): Hopper's warpgroup MMA. A block holds 128
//   query rows of one (b, h), 64 per warpgroup; at D = 256 a thread keeps
//   128 f32 of O, 32 of S and 16 packed p, and `ptxas -v` must report 0
//   spill bytes (chip_smoke.py checks it), so the loop keeps one S tile
//   live at a time. Q is copied once into shared memory; K and V tiles of
//   64 rows go through a ring of stages in dynamic shared memory, fed
//   with `cp.async.cg` 16-byte copies and commit/wait groups, so the next
//   tile's copy overlaps this tile's products. Tiles are laid out in the
//   128-byte (64-byte at D = 32) swizzle that `wgmma` reads through its
//   descriptors. QK^T is `wgmma.mma_async` m64n64k16 (bf16 in, f32
//   accumulate, both operands from shared memory). Softcap, mask and the
//   online max and sum run on the f32 accumulator fragments in registers,
//   row statistics reduce over the four lanes of a quad, and p is rounded
//   to bf16 in registers and fed to the PV product as the register A
//   operand of `wgmma` (m64nDk16, V read transposed from shared memory).
//   The O accumulator stays in f32 registers until it is normalised and
//   stored as bf16.
// * f32: the CUDA cores (67 TFLOP/s peak) with f32 FMAs, since TF32 tensor
//   cores keep about three decimal digits. Q and each K/V tile are staged
//   in shared memory as f32 (rows padded by one float so a warp's row
//   reads fall in distinct banks); a thread owns 4 query rows times D/16
//   output columns and reduces row statistics with warp shuffles across
//   the 16 threads of a row group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBK = 64;   // kv rows of a tile (both kernels)

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32core {

constexpr int kThreads = 256;   // 16 row groups x 16 column lanes
constexpr int kBQ = 64;         // query rows of a block (4 per row group)

template <int D>
constexpr size_t smem_bytes() {
  // q (kBQ x D+1), k (kBK x D+1), v (kBK x D), p (kBQ x kBK+1), f32
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kBQ * (kBK + 1));
}

// Stage `rows` rows of D floats (row r at src + r * stride) in shared
// memory with leading dimension ld; rows >= n_valid become 0. 16-byte
// loads: D is a multiple of 32 and the base is 16-byte aligned.
template <int D>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const float* __restrict__ src,
                                      long stride, int rows, int n_valid) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float* out = dst + r * ld + c;
    const float4 x = r < n_valid
        ? *reinterpret_cast<const float4*>(src + r * stride + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
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
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int sq,
              int skv, int hq, int hkv, float scale, int causal, int window,
              float softcap) {
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
  const float* qb = q + ((long)b * sq + q0) * q_stride + (long)h * D;
  const float* kb = k + (long)b * skv * kv_stride + (long)kh * D;
  const float* vb = v + (long)b * skv * kv_stride + (long)kh * D;

  const int n_q = min(kBQ, sq - q0);
  stage<D>(qs, kLdQ, qb, q_stride, kBQ, n_q);

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
    stage<D>(ks, kLdQ, kb + kv0 * kv_stride, kv_stride, kBK, n_k);
    stage<D>(vs, kLdV, vb + kv0 * kv_stride, kv_stride, kBK, n_k);
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
        ps[(4 * tr + i) * kLdP + tc + 16 * j] = p;
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
    float* o = out + ((long)b * sq + row) * q_stride + (long)h * D;
#pragma unroll
    for (int c = 0; c < kOC; ++c) o[tc + 16 * c] = acc[i][c] / l;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int hq, int hkv, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_f32<D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv, hq,
      hkv, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace f32core

// ---------------------------------------------------------------------------
// bf16: warpgroup MMA (wgmma) on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kSmemLimit = 227 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

using namespace hopper;   // Layout, descriptors, cp.async, wgmma fences

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // round to even
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// d (m64n64, f32) += A (m64k16, bf16) * B (n64k16, bf16); A and B are read
// from shared memory through their descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "},\n"
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64n32, f32) += A (m64k16, bf16, in registers) * B (k16n32, bf16,
// shared memory, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "},\n"
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n64, f32) += A (m64k16, bf16, in registers) * B (k16n64, bf16,
// shared memory, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "},\n"
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, f32) += A (m64k16, bf16, in registers) * B (k16n128, bf16,
// shared memory, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "},\n"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n256, f32) += A (m64k16, bf16, in registers) * B (k16n256, bf16,
// shared memory, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n"
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "},\n"
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// Block shape at head dim D: 128 query rows, 64 a warpgroup, and as many
// K/V stages (at most 3) as shared memory holds beside Q.
template <int D>
struct Config {
  static constexpr int kBQ = 128;                 // query rows of a block
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTile = kBK * D * 2;       // one K or V tile
  static constexpr int kFit = (kSmemLimit - 1024 - kQBytes) / (2 * kTile);
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr size_t kSmem = 1024 + kQBytes + (size_t)kStages * 2 * kTile;
  static_assert(kStages >= 2, "the K/V ring needs two stages");
};

// Copies a tile of R rows (row r at src + r * stride) into its swizzled
// layout at dst, asynchronously; rows >= n_valid become 0.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          long stride, int n_valid) {
  constexpr int kChunks = D / 8;   // 16-byte chunks of a row
  static_assert(R * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < R * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < n_valid;
    cp_async_16(dst + Layout<D>::template offset<R>(r, c),
                src + (ok ? r * stride + c : 0), ok);
  }
}

// Grid (ceil(sq / kBQ), hq, b), 256 threads. Warpgroup wg, warp w, lane l
// holds the accumulator rows wrow + 16w + l/4 and that + 8 (the wgmma
// fragment layout), columns 8j + 2(l%4) + {0, 1}.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, int sq, int skv, int hq,
               int hkv, float scale, int causal, int window, float softcap) {
  using L = Layout<D>;
  using C = Config<D>;
  constexpr int kBQ = C::kBQ, kStages = C::kStages;
  extern __shared__ uint8_t smem_tc[];
  const uint32_t q_s = (smem_addr(smem_tc) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + C::kQBytes;  // stage s: K, then V

  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int wrow = 64 * (threadIdx.x / 128);   // the warpgroup's first row

  // heaviest causal blocks (last query rows) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (hq / hkv);
  const int offset = skv - sq;   // absolute position of query row 0
  const long q_stride = (long)hq * D, kv_stride = (long)hkv * D;
  const __nv_bfloat16* qb = q + ((long)b * sq + q0) * q_stride + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * skv * kv_stride + (long)kh * D;
  const __nv_bfloat16* vb = v + (long)b * skv * kv_stride + (long)kh * D;

  // the kv tiles any row of this block can see
  const int n_q = min(kBQ, sq - q0);
  const int pos_lo = offset + q0, pos_hi = offset + q0 + n_q - 1;
  const int kv_end = causal ? min(skv, pos_hi + 1) : skv;
  const int kv_begin = window > 0 ? max(0, pos_lo - window + 1) / kBK * kBK : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kBK - 1) / kBK : 0;

  auto load_kv = [&](int t) {
    const int kv0 = kv_begin + t * kBK, n = min(kBK, skv - kv0);
    const uint32_t dst = kv_s + (t % kStages) * 2 * C::kTile;
    load_tile<D, kBK>(dst, kb + kv0 * kv_stride, kv_stride, n);
    load_tile<D, kBK>(dst + C::kTile, vb + kv0 * kv_stride, kv_stride, n);
  };
  load_tile<D, kBQ>(q_s, qb, q_stride, n_q);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {   // Q rides in the first group
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  const int r0 = wrow + 16 * warp + lane / 4;   // this thread's rows r0, r0 + 8
  const int qpos0 = offset + q0 + r0, qpos1 = qpos0 + 8;
  const int wg_lo = offset + q0 + wrow, wg_hi = wg_lo + 63;
  // scores in the log2 domain: x = s * scale * log2(e), or with a softcap
  // cap * log2(e) * tanh(s * scale / cap), tanh(t) = 1 - 2 / (2^(2t log2 e) + 1)
  const bool capped = softcap > 0.f;
  const float s_mul = capped ? scale / softcap * 2.f * kLog2e : scale * kLog2e;
  const float cap_log2 = softcap * kLog2e;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // tile t has landed (this thread's part)
    fence_async_proxy();
    __syncthreads();                // ... and every thread's; tile t - 1 is consumed
    if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    cp_async_commit();

    const int kv0 = kv_begin + t * kBK;
    const uint32_t k_s = kv_s + (t % kStages) * 2 * C::kTile;
    const uint32_t v_s = k_s + C::kTile;

    // S = Q K^T over the warpgroup's 64 rows and the tile's 64 kv rows
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t blk = 16 * kk / L::kCols, in_row = 16 * kk % L::kCols * 2;
      wgmma_ss_n64(
          s,
          descriptor(q_s + (blk * kBQ + wrow) * L::kRowBytes + in_row, 16,
                     L::kGroup, L::kMode),
          descriptor(k_s + blk * kBK * L::kRowBytes + in_row, 16, L::kGroup,
                     L::kMode));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // softcap and mask, then the online max and sum (two rows a thread)
    if (capped) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = cap_log2 * (1.f - 2.f * rcp(ex2(s[i] * s_mul) + 1.f));
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= s_mul;
    }
    const bool edge = kv0 + kBK > skv || (causal && kv0 + kBK - 1 > wg_lo) ||
                      (window > 0 && kv0 <= wg_hi - window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = kv0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qp = i & 2 ? qpos1 : qpos0;
        const bool live = kp < skv && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
        if (!live) s[i] = kNegInf;
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    // a row that has seen only masked keys keeps the max -1e30: subtract 0
    // there, so that its masked p are 2^-1e30 = 0
    const float mu0 = mn0 == kNegInf ? 0.f : mn0;
    const float mu1 = mn1 == kNegInf ? 0.f : mn1;
    const float alpha0 = ex2(m0 - mu0), alpha1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(s[i] - (i & 2 ? mu1 : mu0));
      if (i & 2) sum1 += s[i];
      else sum0 += s[i];
    }
    l0 = l0 * alpha0 + sum0;   // this thread's columns; the quad sums at the end
    l1 = l1 * alpha1 + sum1;
    // p rounded to bf16: the accumulator fragment of kv columns
    // 16kk .. 16kk+15 is the A fragment of the PV product's k-step kk
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= i & 2 ? alpha1 : alpha0;

    // O += P V, V read transposed (MN-major) from its tile
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(o, p[kk],
                  descriptor(v_s + 16 * kk * L::kRowBytes, kBK * L::kRowBytes,
                             L::kGroup, L::kMode));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p);
  }
  cp_async_wait<0>();

  const float inv0 = fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = r0 + (i & 2 ? 8 : 0);
    if (row >= n_q) continue;
    const float l = i & 2 ? inv1 : inv0;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(
        out + ((long)b * sq + q0 + row) * q_stride + (long)h * D + col) =
        __floats2bfloat162_rn(o[i] / l, o[i + 1] / l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int hq, int hkv, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  using C = Config<D>;
  auto kernel = flash_fwd_bf16<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + C::kBQ - 1) / C::kBQ, hq, b);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, skv, hq, hkv, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace tc


// Instantiates Launch<D> for the head dims the kernels take.
#define FLASH_FWD_BY_D(ns, d, ...)                                   \
  switch (d) {                                                       \
    case 32: return ns::launch<32>(__VA_ARGS__);                     \
    case 64: return ns::launch<64>(__VA_ARGS__);                     \
    case 128: return ns::launch<128>(__VA_ARGS__);                   \
    case 256: return ns::launch<256>(__VA_ARGS__);                   \
    default: return (int)cudaErrorInvalidValue;                      \
  }

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() as an int (0 = success).
// dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); q, k, v and
// out share it. window <= 0 means no window, softcap <= 0 no softcap; scale
// is d^-1/2.
int flash_fwd(const void* q, const void* k, const void* v, void* out,
              int dtype, int b, int sq, int skv, int hq, int hkv, int d,
              int causal, int window, float softcap, float scale,
              void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FLASH_FWD_BY_D(f32core, d, q, k, v, out, b, sq, skv, hq, hkv, causal,
                   window, softcap, scale, s)
  }
  if (dtype == 1) {
    FLASH_FWD_BY_D(tc, d, q, k, v, out, b, sq, skv, hq, hkv, causal, window,
                   softcap, scale, s)
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
