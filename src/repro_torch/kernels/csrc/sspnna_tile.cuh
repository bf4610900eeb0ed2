// The SSpNNA tile product for Hopper, shared by sspnna_fused.cu (partner
// rows gathered from the global features) and sspnna_tiles.cu (partner
// rows in a pre-gathered stack). The two kernels differ only in a small
// policy, `Rows`, that says where a partner row comes from and where an
// output row goes; the launch geometry, the feed, the product and the
// store are this file's, so both kernels sum in the same order and a
// pre-gathered conv equals the fused one bit for bit.
//
// An implicit GEMM over output rows. Row r = (tile r / dO, slot r % dO)
// of the T * dO rows; on plane k its A row is the partner feature row (C
// channels, zeros for a hole), and out[r] = sum_k A_k[r] @ W[k].
//
// * A block owns `bm` consecutive rows (16 to 128, spanning tiles where
//   dO is small) and `bn` of the N channels (grid.y splits N). Rows a
//   block and the N split come from T * dO, C and N alone, so that each
//   level keeps about two blocks an SM in flight (`geometry`).
// * It first resolves every (row, plane) of its rows to a source row
//   (-1 for a hole) into shared memory, with coalesced reads of
//   local_idx, and lists the planes on which some row of the block has a
//   partner; the other planes cost no copy and no product. The list is
//   the same for every thread, so the plane loop is uniform.
// * A ring of 3 plane stages (2 where C is wide) in dynamic shared
//   memory, each holding A_k (bm x C) and the block's slice of W_k
//   (C x bn), is filled with `cp.async`: 16-byte copies where the row
//   width and the base allow, 4-byte copies otherwise, zero-filled
//   (src-size 0) for holes. The next planes' copies are in flight while
//   this plane's products run; one barrier a stage. bf16 rows at a
//   2-byte alignment, which cp.async cannot take, are copied with plain
//   loads. C is padded to the product's k-step and N to 8 by columns the
//   feed never writes, zeroed once.
// * The product runs on the tensor cores with `mma.sync`: a warp owns 16
//   rows times NT * 8 channels. bf16: m16n8k16 with f32 sums. f32:
//   3xTF32 on m16n8k8, each operand split into a TF32 high part and a
//   TF32 remainder, hi*lo + lo*hi + hi*hi (the lo*lo term is ~2^-22 of a
//   product). Each plane's products go to a fresh accumulator that is
//   then added to the row's f32 sum, so the tensor cores' truncating
//   accumulation only ever sums one plane's C products.
//   `wgmma` is not used: it takes 64-row M tiles and K-major TF32
//   operands, and these products are narrow (C and N 4-128) over 32-row
//   tiles at most levels.
// * Rows and channels are padded with zeros (A pad columns, W pad rows
//   and columns), so a pad contributes exact zeros; the store skips pad
//   rows and channels past N.
//
// What holds it back on the H100 (PERF.md gives the numbers, from the
// SSPNNA_BREAKDOWN timing builds below): the 3xTF32 products, near
// mma.sync's rate, take the larger share; the feed, many small scattered
// rows (16-384 bytes) whose copies stall each warp on the memory pipe as
// it issues them, takes most of the rest. Every warp both feeds and
// multiplies, so the two add up rather than overlap. A producer warp
// with mbarriers (one warp cannot issue the copies fast enough) and
// cp.async.bulk row copies (slower for rows under ~256 bytes) were both
// measured slower than this design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace sspnna {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 256;
constexpr int kBlocksPerSm = 2;             // the launch aims for this many
constexpr int kTwoBlocksSmem = 113 * 1024;  // two blocks an SM
constexpr int kMaxSmem = 227 * 1024;
constexpr int kStages = 3;                  // 2 where 3 do not fit
constexpr int kHole = INT32_MIN;  // a partner slot with no partner

// Timing builds only: chip_smoke.py builds them beside the kernel to split
// its time, and the port's entry points never load them. 1 drops the plane
// feed's copies (the table pass stays), 2 drops the products, 3 keeps one
// TF32 product (hi*hi) of the three. Their results are wrong by design.
#ifndef SSPNNA_BREAKDOWN
#define SSPNNA_BREAKDOWN 0
#endif

// How the feed copies one operand's rows.
enum Copy : int {
  kCopy16 = 0,  // cp.async of 16 bytes
  kCopy4 = 1,   // cp.async of 4 bytes
  kCopy2 = 2,   // plain loads (bf16 rows at a 2-byte alignment)
};

struct Problem {
  int rows;  // T * dO
  int d_o, d_i, k, c, n;
  int a_copy, w_copy;  // Copy of the partner rows and of the weights
};

struct Geometry {
  int bm, bn;          // rows and channels of a block
  int nt, warps_n;     // n8 tiles of a warp; warps across bn
  int stages, n_split;
  int cp;              // C padded to the product's k-step
  int sa, sw;          // row strides (elements) of the A and W stages
  int a_bytes, stage_bytes, smem;
  __host__ __device__ int threads() const { return 32 * (bm / 16) * warps_n; }
};

inline int ceil_div(int x, int m) { return (x + m - 1) / m; }
inline int round_up(int x, int m) { return ceil_div(x, m) * m; }

// The launch geometry, from the shape alone (never from alignment or from
// which kernel asks), so both kernels cut the rows and channels alike.
// Strides: A rows are sa elements apart with sa = 4 (mod 8) in 32-bit
// words, W rows sw apart with sw = 8 (mod 16) words, so a warp's fragment
// reads fall in distinct banks. smem < 0: no geometry fits.
inline Geometry geometry(int rows, int c, int n, int k, int esize,
                         int sms) {
  Geometry g{};
  g.cp = round_up(c > 0 ? c : 1, esize == 4 ? 8 : 16);
  g.sa = g.cp + (esize == 4 ? 4 : 8);
  const int npad = round_up(n, 8);
  const int64_t want = (int64_t)kBlocksPerSm * sms;
  int split = ceil_div(npad, 64);
  int bm = 128;
  while (bm > 32 && (int64_t)ceil_div(rows, bm) * split < want) bm /= 2;
  int bn = round_up(ceil_div(npad, split), 8);
  if ((int64_t)ceil_div(rows, bm) * split < want && bn >= 32) {
    split *= 2;  // few rows (the coarsest level): split N as well
    bn = round_up(ceil_div(npad, split), 8);
  }
  // a warp owns 16 rows x 8 NT channels, NT <= 4; two warps across the
  // block's channels where NT would pass 4, or where the block has room
  // for them (more warps to issue the feed where rows are few)
  int q = bn / 8;
  if (q > 4) q += q & 1;
  g.warps_n = q > 4 || (q % 2 == 0 && bm / 16 * 2 * 32 <= kMaxThreads) ? 2 : 1;
  g.nt = q / g.warps_n;
  g.bn = 8 * q;
  while (bm / 16 * g.warps_n * 32 > kMaxThreads) bm /= 2;
  g.n_split = ceil_div(n, g.bn);
  g.sw = g.bn % 16 == 0 ? g.bn + 8 : g.bn;
  const int w_bytes = g.cp * g.sw * esize;
  auto smem = [&](int m, int stages) {
    const int tables = (m * k + 2 * m + 2 * k + 1) * 4;
    return stages * (m * g.sa * esize + w_bytes) + round_up(tables, 16);
  };
  g.smem = -1;
  for (; bm >= 16 && g.smem < 0; bm /= 2) {
    for (int limit : {kTwoBlocksSmem, kMaxSmem})
      for (int s = kStages; s >= 2 && g.smem < 0; --s)
        if (smem(bm, s) <= limit) g.stages = s, g.smem = smem(bm, s);
    if (g.smem >= 0) g.bm = bm;
  }
  g.a_bytes = g.bm * g.sa * esize;
  g.stage_bytes = g.a_bytes + w_bytes;
  return g;
}

template <typename T>
int copy_mode(const void* base, int64_t row_elems) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  const int64_t bytes = row_elems * (int64_t)sizeof(T);
  if (a % 16 == 0 && bytes % 16 == 0) return kCopy16;
  if (a % 4 == 0 && bytes % 4 == 0) return kCopy4;
  return kCopy2;
}

// ---------------------------------------------------------------------------
// Device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes from global to shared memory, asynchronously; zeros where
// !valid (src is then not read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits until the oldest of the `stages - 1` planes in flight has landed.
__device__ __forceinline__ void wait_oldest(int stages) {
  static_assert(kStages == 3, "one wait_group count a ring depth");
  if (stages == 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same_v<T, float>)
    return v;
  else
    return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// A thread's share of copying rows of `width` elements in pieces of
// `per`: pieces col, col + cstep, ... of rows row0, row0 + rstep, ...
// Fixed for the kernel, so the plane loop divides nothing.
struct Share {
  int mode, per, pieces, col, cstep, row0, rstep;
};

template <typename T>
__device__ __forceinline__ Share share_of(int mode, int width, int tid,
                                          int nthreads) {
  const int per = mode == kCopy16 ? 16 / (int)sizeof(T)
                  : mode == kCopy4 ? 4 / (int)sizeof(T) : 1;
  const int pieces = width / per;
  if (pieces > nthreads || pieces == 0)
    return {mode, per, pieces, tid, nthreads, 0, 1};
  const int rstep = nthreads / pieces;  // threads past rstep rows idle
  return {mode, per, pieces, tid % pieces, pieces,
          tid < rstep * pieces ? tid / pieces : INT32_MAX, rstep};
}

// Copies `rows` rows into dst (leading dimension ld), this thread's
// share: row i from src_row(i), zeros where that is null. `any` is a
// valid global address, passed for the zero-filled copies, which read
// nothing.
template <typename T, typename RowPtr>
__device__ __forceinline__ void feed(T* dst, int ld, int rows,
                                     const Share& sh, const T* any,
                                     RowPtr src_row) {
  for (int i = sh.row0; i < rows; i += sh.rstep) {
    const T* s = src_row(i);
    T* d = dst + i * ld;
    for (int c = sh.col; c < sh.pieces; c += sh.cstep) {
      const int j = c * sh.per;
      if (sh.mode == kCopy16)
        cp_async_16(d + j, s ? s + j : any, s != nullptr);
      else if (sh.mode == kCopy4)
        cp_async_4(d + j, s ? s + j : any, s != nullptr);
      else
        d[j] = s ? s[j] : from_float<T>(0.f);
    }
  }
}

// x = hi + lo + O(2^-22 |x|), both TF32, rounded to nearest (ties away
// from zero) by adding half a TF32 ulp to the bits: hi keeps the top 19
// bits; lo = x - hi is exact in f32, and its low 13 bits are left in
// place because the tensor core ignores them (CUTLASS's "fast accurate"
// 3xTF32 split, without cvt.rna's handling of inf and NaN, which costs
// four more instructions a value).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t load_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 in one register, the lower k index in the low half.
__device__ __forceinline__ uint32_t pack_pair(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// acc += A (16 x cp, leading dimension sa) @ W (cp x NT*8, leading
// dimension sw), one warp, fragments as the PTX ISA lays out mma.sync's.
template <typename T, int NT>
__device__ __forceinline__ void warp_product(float (&acc)[NT][4], const T* a,
                                             int sa, const T* w, int sw,
                                             int cp, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll 2
    for (int kk = 0; kk < cp; kk += 8) {
      const float* ar = a + gid * sa + kk + tig;
      uint32_t ahi[4], alo[4];
      split_tf32(ar[0], ahi[0], alo[0]);
      split_tf32(ar[8 * sa], ahi[1], alo[1]);
      split_tf32(ar[4], ahi[2], alo[2]);
      split_tf32(ar[8 * sa + 4], ahi[3], alo[3]);
      const float* wr = w + (kk + tig) * sw + gid;
      uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        split_tf32(wr[j * 8], bhi[j][0], blo[j][0]);
        split_tf32(wr[4 * sw + j * 8], bhi[j][1], blo[j][1]);
      }
      // per channel tile lo*hi, hi*lo, then hi*hi; the tiles' products are
      // independent, so each term runs over all of them back to back
      if constexpr (SSPNNA_BREAKDOWN != 3) {
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[j], alo, bhi[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ahi, blo[j]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ahi, bhi[j]);
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < cp; kk += 16) {
      const bf16* ar = a + gid * sa + kk + 2 * tig;
      const uint32_t af[4] = {load_pair(ar), load_pair(ar + 8 * sa),
                              load_pair(ar + 8), load_pair(ar + 8 * sa + 8)};
      const bf16* wr = w + (kk + 2 * tig) * sw + gid;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* wj = wr + j * 8;
        const uint32_t bf[2] = {pack_pair(wj[0], wj[sw]),
                                pack_pair(wj[8 * sw], wj[9 * sw])};
        mma_bf16(acc[j], af, bf);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// `rows_of.resolve(dst, t, li)` writes to shared `dst`, directly or by
// cp.async, the source row of tile t's slot li (li in [0, dI)), read
// from `feats` at row * C (a negative row reads row 0).
// `rows_of.dest(r, dO)`: the output row of row r, or -1 to store nothing.
template <typename T, int NT, typename Rows>
__global__ void __launch_bounds__(kMaxThreads, 1)
tile_kernel(const Rows rows_of, const T* __restrict__ feats,
            const T* __restrict__ weights,
            const int32_t* __restrict__ local_idx, T* __restrict__ out,
            const Problem pb, const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int r0 = blockIdx.x * g.bm, n0 = blockIdx.y * g.bn;
  const int nv = min(g.bn, pb.n - n0);  // channels of this block
  int* partner = reinterpret_cast<int*>(smem + g.stages * g.stage_bytes);
  int* dest = partner + g.bm * pb.k;
  int* tile_of = dest + g.bm;
  int* live = tile_of + g.bm;
  int* planes = live + pb.k;
  int* n_live_at = planes + pb.k;

  for (int e = tid; e < pb.k; e += nthreads) live[e] = 0;

  // Each (row, plane) to its source row, once: the block's local_idx rows
  // are copied asynchronously, then each partner slot is resolved (the
  // fused kernel's in_rows lookups are asynchronous copies too), then, by
  // the thread that resolved it, holes and pads are settled. Two round
  // trips to memory in all, not one per entry.
  const int n_idx = min(g.bm, pb.rows - r0) * pb.k;
  const int32_t* idx = local_idx + (int64_t)r0 * pb.k;
  const int n_vec = reinterpret_cast<uintptr_t>(idx) % 16 == 0 ? n_idx & ~3 : 0;
  for (int e = 4 * tid; e < n_vec; e += 4 * nthreads)
    cp_async_16(partner + e, idx + e, true);
  for (int e = n_vec + tid; e < n_idx; e += nthreads)
    cp_async_4(partner + e, idx + e, true);
  cp_async_commit();
  for (int row = tid; row < g.bm; row += nthreads) {
    const int r = r0 + row;
    tile_of[row] = r / pb.d_o;
    dest[row] = r < pb.rows ? rows_of.dest(r, pb.d_o) : -1;
  }
  cp_async_wait<0>();
  __syncthreads();  // local_idx, tile_of, the cleared flags
  // entry e = row * k + plane, stepped without dividing
  const int planes_k = max(pb.k, 1);
  const int drow = nthreads / planes_k, dplane = nthreads - drow * planes_k;
  for (int e = tid, row = tid / planes_k, k = tid - row * planes_k;
       e < g.bm * pb.k; e += nthreads, row += drow, k += dplane) {
    if (k >= pb.k) k -= pb.k, ++row;
    const int li = e < n_idx ? partner[e] : -1;
    if (li >= 0 && li < pb.d_i) {
      rows_of.resolve(partner + e, tile_of[row], li);
      live[k] = 1;
    } else {
      partner[e] = kHole;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  for (int e = tid; e < g.bm * pb.k; e += nthreads) {
    const int p = partner[e];
    partner[e] = p == kHole ? -1 : max(p, 0);  // raw-layout pads read row 0
  }
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int k = 0; k < pb.k; ++k)
      if (live[k]) planes[m++] = k;
    *n_live_at = m;
  }
  __syncthreads();
  const int n_live = *n_live_at;
  if (n_live > 0) {  // uniform; a block of holes copies and zeroes nothing
    // zero the pads of every stage, which the feed never writes: A's
    // columns [C, cp), W's rows [C, cp) and its channels past N
    const int a_pad = g.cp - pb.c, w_cols = g.bn - nv;
    for (int st = 0; st < g.stages; ++st) {
      T* a = reinterpret_cast<T*>(smem + st * g.stage_bytes);
      T* w = reinterpret_cast<T*>(smem + st * g.stage_bytes + g.a_bytes);
      for (int e = tid; e < g.bm * a_pad; e += nthreads)
        a[(e / a_pad) * g.sa + pb.c + e % a_pad] = from_float<T>(0.f);
      for (int e = tid; e < a_pad * g.bn; e += nthreads)
        w[(pb.c + e / g.bn) * g.sw + e % g.bn] = from_float<T>(0.f);
      for (int e = tid; e < pb.c * w_cols; e += nthreads)
        w[(e / w_cols) * g.sw + nv + e % w_cols] = from_float<T>(0.f);
    }
    __syncthreads();
  }

  auto a_stage = [&](int s) {
    return reinterpret_cast<T*>(smem + s * g.stage_bytes);
  };
  auto w_stage = [&](int s) {
    return reinterpret_cast<T*>(smem + s * g.stage_bytes + g.a_bytes);
  };
  const Share a_share = share_of<T>(pb.a_copy, pb.c, tid, nthreads);
  const Share w_share = share_of<T>(pb.w_copy, nv, tid, nthreads);
  auto issue = [&](int j) {  // the j-th live plane into stage j % stages
    if constexpr (SSPNNA_BREAKDOWN == 1) return;
    const int k = planes[j], s = j % g.stages;
    feed(a_stage(s), g.sa, g.bm, a_share, feats, [&](int i) -> const T* {
      const int p = partner[i * pb.k + k];
      return p >= 0 ? feats + (int64_t)p * pb.c : nullptr;
    });
    const T* wk = weights + (int64_t)k * pb.c * pb.n + n0;
    feed(w_stage(s), g.sw, pb.c, w_share, weights,
         [&](int i) -> const T* { return wk + (int64_t)i * pb.n; });
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / g.warps_n, wn = warp - wm * g.warps_n;
  float sum[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[j][i] = 0.f;

  for (int j = 0; j < g.stages - 1; ++j) {
    if (j < n_live) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < n_live; ++j) {
    wait_oldest(g.stages);
    __syncthreads();  // plane j landed for all; stage (j-1) % stages free
    if (j + g.stages - 1 < n_live) issue(j + g.stages - 1);
    cp_async_commit();
    const int s = j % g.stages;
    float acc[NT][4];
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[jj][i] = 0.f;
    if constexpr (SSPNNA_BREAKDOWN != 2)
      warp_product<T, NT>(acc, a_stage(s) + wm * 16 * g.sa, g.sa,
                          w_stage(s) + wn * NT * 8, g.sw, g.cp, lane);
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[jj][i] += acc[jj][i];
  }
  cp_async_wait<0>();

  // the accumulator fragment: rows gid and gid + 8, channels 2 tig, +1
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + (wn * NT + j) * 8 + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = dest[wm * 16 + gid + 8 * h];
      if (d < 0) continue;
      T* o = out + (int64_t)d * pb.n + col;
      if (col < pb.n) o[0] = from_float<T>(sum[j][2 * h]);
      if (col + 1 < pb.n) o[1] = from_float<T>(sum[j][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

inline int device_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename T, typename Rows>
using Kernel = void (*)(Rows, const T*, const T*, const int32_t*, T*,
                        Problem, Geometry);

// The kernel of a geometry (its NT), allowed the shared memory it needs.
template <typename T, typename Rows>
cudaError_t kernel_for(const Geometry& g, Kernel<T, Rows>* kernel) {
  *kernel = g.nt == 1   ? tile_kernel<T, 1, Rows>
            : g.nt == 2 ? tile_kernel<T, 2, Rows>
            : g.nt == 3 ? tile_kernel<T, 3, Rows>
                        : tile_kernel<T, 4, Rows>;
  return g.smem > 48 * 1024
             ? cudaFuncSetAttribute(*kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    g.smem)
             : cudaSuccess;
}

// {grid.x, grid.y, threads, rows a block, channels a block, stages,
// shared memory bytes, blocks an SM holds} of a launch over n_tiles * d_o
// rows; returns 0, or a CUDA error where no geometry fits.
template <typename T, typename Rows>
int describe(int n_tiles, int d_o, int k, int c, int n, int* shape) {
  const int64_t rows = (int64_t)n_tiles * d_o;
  if (rows <= 0 || rows >= INT32_MAX || n <= 0 || k < 0 || c < 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry((int)rows, c, n, k, sizeof(T), device_sms());
  if (g.smem < 0) return (int)cudaErrorInvalidValue;
  Kernel<T, Rows> kernel = nullptr;
  int per_sm = 0;
  cudaError_t err = kernel_for<T, Rows>(g, &kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        g.threads(), g.smem);
  if (err != cudaSuccess) return (int)err;
  const int values[8] = {ceil_div((int)rows, g.bm), g.n_split, g.threads(),
                         g.bm, g.bn, g.stages, g.smem, per_sm};
  for (int i = 0; i < 8; ++i) shape[i] = values[i];
  return 0;
}

template <typename T, typename Rows>
int launch(const Rows& rows_of, const T* feats, const T* weights,
           const int32_t* local_idx, T* out, int n_tiles, int d_o, int d_i,
           int k, int c, int n, cudaStream_t stream) {
  const int64_t rows = (int64_t)n_tiles * d_o;
  if (n_tiles <= 0 || d_o <= 0 || d_i < 0 || k < 0 || c < 0 || n <= 0 ||
      rows >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry((int)rows, c, n, k, sizeof(T), device_sms());
  if (g.smem < 0 || g.n_split > 65535) return (int)cudaErrorInvalidValue;
  const Problem pb{(int)rows, d_o, d_i, k, c, n,
                   copy_mode<T>(feats, c), copy_mode<T>(weights, n)};
  Kernel<T, Rows> kernel = nullptr;
  const cudaError_t err = kernel_for<T, Rows>(g, &kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div((int)rows, g.bm), g.n_split);
  kernel<<<grid, g.threads(), g.smem, stream>>>(rows_of, feats, weights,
                                                local_idx, out, pb, g);
  return (int)cudaGetLastError();
}

}  // namespace sspnna
