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
// What bounds it on the card. Prefill (Moonshot: C = 968 capacity slots of
// 2048 or 1408 wide rows per expert, about a third of them valid) moves
// w once and writes all of out, valid or not: ~0.24 ms of bytes at 3.35
// TB/s against ~0.12 ms of bf16 tensor-core work, so it is bound by bytes,
// and a tile that reads its operands from L2 more than once a product
// soon makes it bound by L2's rate. Decode (C = 8) does 2 FLOPs per byte
// of w: it is bound by reading the w of the experts some token chose.
//
// What the design does about that. bf16 inputs take one of two kernels,
// chosen by C; f32 inputs (the f32 parity gates only: TF32 would break
// their 1e-5 tolerance) run on the CUDA cores.
//
// * prefill::tile_kernel (C >= 64): a block computes 128 valid rows of
//   one expert by 128 columns. Its rows are the expert's valid rows
//   numbered in order (the block scans valid[e] itself), so the rows a
//   tile multiplies are live ones wherever the dispatch left them; grid
//   block m also writes the zeros of the invalid rows of rows
//   128m .. 128m + 127, and a block with no valid rows left reads no w.
//   Two consumer warpgroups each run `wgmma` m64n128k16 from shared memory
//   (x K-major, w N-major through a transposed descriptor) into f32
//   registers. x rows (gathered) and w rows arrive in 64-deep steps
//   through a 3-stage ring of 16-byte `cp.async` copies in the 128-byte
//   swizzle, two steps ahead of the product; two blocks share an SM, so
//   one's copies, epilogue or zeros overlap the other's products. The
//   epilogue stores from registers.
//   The grid runs the row tiles of one (expert, column tile) next to each
//   other, so w is read from device memory about once.
// * decode::slab_kernel (C < 64): a block owns 64 columns of one expert
//   and all C rows (zero-padded to 16 or 64). An expert no row chose
//   writes its zeros and reads nothing more. Live blocks stream their 64
//   columns of w over d through a 6-stage `cp.async` ring; each of 4 warps
//   takes one 16-deep step of every stage on `mma.sync` m16n8k16, and the
//   four partial sums are added in warp order, so results are bitwise
//   reproducible. At Moonshot's decode (~12 of 64 experts live) that is
//   ~260-380 blocks each streaming 176-256 KB of w.
//
// Copies are 16 bytes where d, f and the bases allow, else plain 2-byte
// loads into the same layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// CUDA-core path (f32 inputs)
constexpr int kBM = 64;              // rows (capacity slots) of a tile
constexpr int kBN = 64;              // output columns of a tile
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

// Writes zeros to the rows of [m0, m0 + rows) that are not valid, in
// columns [n0, n0 + cols), clipped to C and f: a warp a row, with 16-byte
// stores where the row's run is 16-byte aligned.
template <typename OutT>
__device__ void zero_invalid_rows(OutT* __restrict__ out_e,
                                  const uint8_t* __restrict__ valid_e, int m0,
                                  int rows, int n0, int cols, int c, int f) {
  constexpr int kPer = 16 / sizeof(OutT);   // values a 16-byte store
  const int nr = min(rows, c - m0), nc = min(cols, f - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = m0 + warp; r < m0 + nr; r += blockDim.x / 32) {
    if (valid_e[r]) continue;
    OutT* o = out_e + (long)r * f + n0;
    if (reinterpret_cast<uintptr_t>(o) % 16 == 0 && nc % kPer == 0) {
      for (int i = lane * kPer; i < nc; i += 32 * kPer)
        *reinterpret_cast<uint4*>(o + i) = make_uint4(0, 0, 0, 0);
    } else {
      for (int i = lane; i < nc; i += 32) o[i] = from_f32<OutT>(0.f);
    }
  }
}

// Stores a and b at columns n and n + 1 of row p, those below f.
template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* __restrict__ p, int n, int f,
                                           float a, float b) {
  if (f % 2 == 0 && n + 1 < f) {   // the pair is aligned: one store
    if constexpr (sizeof(OutT) == 4)
      *reinterpret_cast<float2*>(p + n) = make_float2(a, b);
    else
      *reinterpret_cast<__nv_bfloat162*>(p + n) = __floats2bfloat162_rn(a, b);
  } else {
    if (n < f) p[n] = from_f32<OutT>(a);
    if (n + 1 < f) p[n + 1] = from_f32<OutT>(b);
  }
}

// Lets Kernel take `bytes` of dynamic shared memory, once a device rather
// than at every launch: decode steps are bound by the host's launches, and
// cudaFuncSetAttribute would add host time to each of them.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static std::atomic<uint64_t> done{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done.load() >> dev & 1))) return err;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done.fetch_or(uint64_t{1} << dev);
  return err;
}

// Copies the 8 values row[col .. col + 7] that lie below len (none if row
// is null) to the 16 bytes at shared address dst, zeros elsewhere. kVec:
// len is a multiple of 8 and row is 16-byte aligned, so one asynchronous
// 16-byte copy does it (zero-filled where it reads nothing; any is a
// valid address it is then given but does not read). Else plain 2-byte
// loads and one 16-byte shared store.
template <bool kVec>
__device__ __forceinline__ void copy_chunk(uint32_t dst, const bf16* row,
                                           int col, int len, const bf16* any) {
  if constexpr (kVec) {
    const bool ok = row != nullptr && col < len;
    cp_async_16(dst, ok ? row + col : any, ok);
  } else {
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = col + 2 * i;
      const uint32_t lo = row && j < len ? __bfloat16_as_ushort(row[j]) : 0u;
      const uint32_t hi =
          row && j + 1 < len ? __bfloat16_as_ushort(row[j + 1]) : 0u;
      v[i] = lo | hi << 16;
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// ---------------------------------------------------------------------------
// bf16, C >= 64: wgmma tiles of 128 valid rows x 128 columns
// ---------------------------------------------------------------------------

namespace prefill {

constexpr int kThreads = 256;   // two consumer warpgroups, 64 rows each
constexpr int kBM = 128;        // valid rows of a tile
constexpr int kBN = 128;        // output columns of a tile
constexpr int kBK = 64;         // depth of a step: one 128-byte row of x
constexpr int kStages = 3;      // ring depth; copies run two steps ahead
using LA = Layout<kBK>;         // x step: kBM rows of kBK, K-major
using LB = Layout<kBN>;         // w step: kBK rows of kBN (two 64-column
                                // blocks), read N-major
constexpr int kTileA = kBM * kBK * 2;
constexpr int kTileB = kBK * kBN * 2;
constexpr int kStage = kTileA + kTileB;
constexpr size_t kSmem = 1024 + (size_t)kStages * kStage;   // + alignment
static_assert(LA::kRowBytes == 128 && LB::kRowBytes == 128, "B128 swizzle");

// d (m64n128, f32) += A (m64k16, bf16, K-major) * B (k16n128, bf16,
// N-major: transposed), both read from shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
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
      "%64, %65, p, 1, 1, 0, 1;\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// Numbers the valid rows of valid_e (C bytes) in order and writes the row
// index of numbers m0 .. m0 + kBM - 1 to rows_s; returns how many of those
// there are (0 .. kBM). Each thread scans one run of rows; the runs' counts
// are summed over the block.
__device__ __forceinline__ int live_rows(const uint8_t* __restrict__ valid_e,
                                         int c, int m0, int* rows_s,
                                         int* sums_s) {
  const int run = (c + kThreads - 1) / kThreads;
  const int lo = min(c, (int)threadIdx.x * run), hi = min(c, lo + run);
  int n = 0;
  for (int r = lo; r < hi; ++r) n += valid_e[r] != 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = n;   // inclusive sum over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sums_s[warp] = incl;
  __syncthreads();
  int rank = incl - n, total = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    const int s = sums_s[i];
    rank += i < warp ? s : 0;
    total += s;
  }
  if (rank < m0 + kBM && rank + n > m0) {
    for (int r = lo; r < hi; ++r) {
      if (!valid_e[r]) continue;
      if (rank >= m0 && rank < m0 + kBM) rows_s[rank - m0] = r;
      ++rank;
    }
  }
  __syncthreads();
  return min(max(total - m0, 0), kBM);
}

// Grid (ceil(C / kBM), ceil(f / kBN), E), kThreads threads. Warpgroup wg,
// warp w, lane l holds the accumulator rows 64wg + 16w + l/4 and that + 8
// of the tile (the wgmma fragment layout), columns 8j + 2(l%4) + {0, 1}.
// Two blocks an SM (the 2-byte-load variant, off every served shape, one),
// so one block's copies, epilogue or zeros overlap the other's products.
template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads, kVec ? 2 : 1)
tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
            const uint8_t* __restrict__ valid, OutT* __restrict__ out, int c,
            int d, int f) {
  extern __shared__ uint8_t tile_smem[];
  __shared__ int rows_s[kBM];
  __shared__ int sums_s[kThreads / 32];

  const int e = blockIdx.z, n0 = blockIdx.y * kBN, m0 = blockIdx.x * kBM;
  const uint8_t* valid_e = valid + (long)e * c;
  OutT* out_e = out + (long)e * c * f;
  const int n_live = live_rows(valid_e, c, m0, rows_s, sums_s);
  if (n_live == 0) {
    zero_invalid_rows(out_e, valid_e, m0, kBM, n0, kBN, c, f);
    return;
  }

  const uint32_t ring = (smem_addr(tile_smem) + 1023) & ~1023u;
  const bf16* x_e = x + (long)e * c * d;
  const bf16* w_e = w + (long)e * d * f;
  // this thread's copies: x chunk xc of tile rows xr + 32j (gathered), w
  // chunk wc of step rows wr + 16j
  const int xr = threadIdx.x / 8, xc = (threadIdx.x % 8) * 8;
  const int wr = threadIdx.x / 16, wc = (threadIdx.x % 16) * 8;
  const bf16* x_rows[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = xr + 32 * j;
    x_rows[j] = i < n_live ? x_e + (long)rows_s[i] * d : nullptr;
  }
  const int n_steps = (d + kBK - 1) / kBK;

  auto load = [&](int t) {
    const int k0 = t * kBK;
    const uint32_t a_s = ring + (t % kStages) * kStage, b_s = a_s + kTileA;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      copy_chunk<kVec>(a_s + LA::offset<kBM>(xr + 32 * j, xc), x_rows[j],
                       k0 + xc, d, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + wr + 16 * j;
      copy_chunk<kVec>(b_s + LB::offset<kBK>(wr + 16 * j, wc),
                       k < d ? w_e + (long)k * f + n0 : nullptr, wc, f - n0,
                       w);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_steps) load(t);
    cp_async_commit();
  }
  zero_invalid_rows(out_e, valid_e, m0, kBM, n0, kBN, c, f);

  // Both warpgroups multiply every step, also one whose 64 rows lie past
  // n_live (zeros): a branch around wgmma makes ptxas serialize them.
  const int wg = threadIdx.x / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<kStages - 2>();   // step t has landed (this thread's part)
    fence_async_proxy();
    __syncthreads();   // ... and every thread's; step t - 1 is consumed
    if (t + kStages - 1 < n_steps) load(t + kStages - 1);
    cp_async_commit();
    const uint32_t a_s = ring + (t % kStages) * kStage + 64 * wg * 128;
    const uint32_t b_s = ring + (t % kStages) * kStage + kTileA;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_n128(acc, descriptor(a_s + 32 * kk, 16, LA::kGroup, LA::kMode),
                 descriptor(b_s + 16 * kk * LB::kRowBytes, kBK * LB::kRowBytes,
                            LB::kGroup, LB::kMode));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int r0 = 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= n_live) continue;
    OutT* o = out_e + (long)rows_s[r] * f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      store_pair(o, n0 + 8 * j + 2 * (lane % 4), f, acc[4 * j + 2 * half],
                 acc[4 * j + 2 * half + 1]);
  }
}

template <typename OutT, bool kVec>
int launch(const bf16* x, const bf16* w, const uint8_t* valid, OutT* out,
           int e, int c, int d, int f, cudaStream_t stream) {
  const cudaError_t err = allow_smem<tile_kernel<OutT, kVec>>((int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c + kBM - 1) / kBM, (f + kBN - 1) / kBN, e);
  tile_kernel<OutT, kVec><<<grid, kThreads, kSmem, stream>>>(x, w, valid, out,
                                                             c, d, f);
  return (int)cudaGetLastError();
}

}  // namespace prefill

// ---------------------------------------------------------------------------
// bf16, C < 64: column slabs of w streamed at the memory's rate
// ---------------------------------------------------------------------------

namespace decode {

constexpr int kBN = 64;         // output columns of a block
constexpr int kBK = 64;         // depth of a stage
constexpr int kStages = 6;
constexpr int kWarps = kBK / 16;   // each takes one 16-deep step of a stage
constexpr int kThreads = 32 * kWarps;
constexpr int kLdW = kBN + 8;   // row pitches (144 bytes): the 8 rows of
constexpr int kLdX = kBK + 8;   // an ldmatrix fall on distinct banks
constexpr int kWChunks = kBN / 8;            // 16-byte chunks of a w row
constexpr int kWRows = kThreads / kWChunks;  // w rows one pass copies
static_assert(kThreads == 16 * (kBK / 8), "one pass copies 16 x rows");

// MT: row tiles of 16 (C <= 16 * MT).
template <int MT>
struct Ring {
  static constexpr int kW = kBK * kLdW * 2;        // w rows of a stage
  static constexpr int kX = 16 * MT * kLdX * 2;    // x rows of a stage
  static constexpr int kStage = kW + kX;
  static constexpr int kSmem = kStages * kStage;
  static_assert(kSmem >= kWarps * 16 * MT * kBN * 4, "the partial sums fit");
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (m16n8, f32) += a (m16k16, bf16, row) * b (k16n8, bf16, col)
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid (ceil(f / kBN), E), kThreads threads. Warp w multiplies the rows
// 16w .. 16w + 15 of every stage's depth; lane l holds the fragment rows
// 16mt + l/4 and that + 8, columns 8nb + 2(l%4) + {0, 1}.
template <typename OutT, bool kVec, int MT>
__global__ void __launch_bounds__(kThreads)
slab_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
            const uint8_t* __restrict__ valid, OutT* __restrict__ out, int c,
            int d, int f) {
  using R = Ring<MT>;
  extern __shared__ __align__(16) uint8_t slab_smem[];
  __shared__ uint8_t vs[16 * MT];

  const int e = blockIdx.y, n0 = blockIdx.x * kBN;
  const uint8_t* valid_e = valid + (long)e * c;
  OutT* out_e = out + (long)e * c * f;
  int live = 0;
  if (threadIdx.x < 16 * MT) {
    const uint8_t v = threadIdx.x < c ? valid_e[threadIdx.x] : 0;
    vs[threadIdx.x] = v;
    live = v != 0;
  }
  if (!__syncthreads_or(live)) {   // no token chose this expert
    zero_invalid_rows(out_e, valid_e, 0, c, n0, kBN, c, f);
    return;
  }

  const uint32_t ring = smem_addr(slab_smem);
  const bf16* x_e = x + (long)e * c * d;
  const bf16* w_e = w + (long)e * d * f;
  // this thread's copies: w chunk wc of stage rows wr + kWRows j, x chunk
  // xc of rows xr + 16j (valid rows only)
  const int wr = threadIdx.x / kWChunks, wc = (threadIdx.x % kWChunks) * 8;
  const int xr = threadIdx.x / (kBK / 8), xc = (threadIdx.x % (kBK / 8)) * 8;
  const int n_steps = (d + kBK - 1) / kBK;

  auto load = [&](int t) {
    const int k0 = t * kBK;
    const uint32_t w_s = ring + (t % kStages) * R::kStage, x_s = w_s + R::kW;
#pragma unroll
    for (int j = 0; j < kBK / kWRows; ++j) {
      const int r = wr + kWRows * j, k = k0 + r;
      copy_chunk<kVec>(w_s + (r * kLdW + wc) * 2,
                       k < d ? w_e + (long)k * f + n0 : nullptr, wc, f - n0,
                       w);
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int r = xr + 16 * j;
      copy_chunk<kVec>(x_s + (r * kLdX + xc) * 2,
                       vs[r] ? x_e + (long)r * d : nullptr, k0 + xc, d, x);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_steps) load(t);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[MT][kBN / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nb][i] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<kStages - 2>();   // stage t has landed (this thread's part)
    __syncthreads();   // ... and every thread's; stage t - 1 is consumed
    if (t + kStages - 1 < n_steps) load(t + kStages - 1);
    cp_async_commit();

    const uint32_t w_s = ring + (t % kStages) * R::kStage, x_s = w_s + R::kW;
    // B fragments of the warp's 16 rows of depth and the kBN columns
    uint32_t b[kBN / 16][4];
#pragma unroll
    for (int h = 0; h < kBN / 16; ++h)
      ldmatrix_x4_trans(
          b[h], w_s + ((16 * warp + lane % 8 + (lane / 8 % 2) * 8) * kLdW +
                       16 * h + (lane / 16) * 8) * 2);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, x_s + ((16 * mt + lane % 16) * kLdX + 16 * warp +
                            (lane / 16) * 8) * 2);
#pragma unroll
      for (int nb = 0; nb < kBN / 8; ++nb)
        mma_m16n8k16(acc[mt][nb], a, b[nb / 2][2 * (nb % 2)],
                     b[nb / 2][2 * (nb % 2) + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it takes the warps' partial sums

  float* part = reinterpret_cast<float*>(slab_smem);   // [warp][row][column]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * mt + lane / 4 + (i & 2 ? 8 : 0);
        const int col = 8 * nb + 2 * (lane % 4) + (i & 1);
        part[(warp * 16 * MT + r) * kBN + col] = acc[mt][nb][i];
      }
  __syncthreads();
  const int rows = min(c, 16 * MT);
  for (int i = threadIdx.x; i < rows * kBN; i += kThreads) {
    const int r = i / kBN, col = i % kBN;
    if (n0 + col >= f) continue;
    float s = 0.f;
    if (vs[r]) {   // the warps' sums in a fixed order
#pragma unroll
      for (int v = 0; v < kWarps; ++v) s += part[(v * 16 * MT + r) * kBN + col];
    }
    out_e[(long)r * f + n0 + col] = from_f32<OutT>(s);
  }
}

template <typename OutT, bool kVec, int MT>
int launch_rows(dim3 grid, const bf16* x, const bf16* w, const uint8_t* valid,
                OutT* out, int c, int d, int f, cudaStream_t stream) {
  const cudaError_t err =
      allow_smem<slab_kernel<OutT, kVec, MT>>(Ring<MT>::kSmem);
  if (err != cudaSuccess) return (int)err;
  slab_kernel<OutT, kVec, MT><<<grid, kThreads, Ring<MT>::kSmem, stream>>>(
      x, w, valid, out, c, d, f);
  return (int)cudaGetLastError();
}

template <typename OutT, bool kVec>
int launch(const bf16* x, const bf16* w, const uint8_t* valid, OutT* out,
           int e, int c, int d, int f, cudaStream_t stream) {
  const dim3 grid((f + kBN - 1) / kBN, e);
  if (c <= 16) return launch_rows<OutT, kVec, 1>(grid, x, w, valid, out, c, d,
                                                  f, stream);
  return launch_rows<OutT, kVec, 4>(grid, x, w, valid, out, c, d, f, stream);
}

}  // namespace decode

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
                int e, int c, int d, int f, cudaStream_t s) {
  const bool vec = d % 8 == 0 && f % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  OutT* o = static_cast<OutT*>(out);
  if (c < 64)
    return vec ? decode::launch<OutT, true>(xb, wb, valid, o, e, c, d, f, s)
               : decode::launch<OutT, false>(xb, wb, valid, o, e, c, d, f, s);
  return vec ? prefill::launch<OutT, true>(xb, wb, valid, o, e, c, d, f, s)
             : prefill::launch<OutT, false>(xb, wb, valid, o, e, c, d, f, s);
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
// 1 = bfloat16. valid holds one byte (0 or 1) per row; out is at least
// 8-byte aligned (a fresh allocation).
int moe_gemm(const void* x, const void* w, const void* valid, void* out,
             int dtype, int out_dtype, int e, int c, int d, int f,
             void* stream) {
  if (e <= 0 || c <= 0 || d < 0 || f <= 0 || e > 65535 ||
      (c + kBM - 1) / kBM > 65535 ||
      (f + prefill::kBN - 1) / prefill::kBN > 65535)
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
