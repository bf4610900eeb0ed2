// Hopper primitives shared by the port's tensor-core kernels
// (flash_fwd.cu, moe_gemm.cu): the swizzled shared-memory layout that
// `wgmma` reads through its matrix descriptors, the descriptors
// themselves, asynchronous 16-byte copies from global to shared memory
// (`cp.async`) with their commit and wait groups, the fence that makes
// those copies visible to `wgmma`'s async proxy, the warpgroup fences,
// commits and waits, and a register fence that keeps the compiler from
// moving accumulator reads or writes across an asynchronous product.
// Compiled for sm_90a only (`wgmma` exists on no other target).
// `build.library_path` hashes this header with every source that
// includes it, so an edit rebuilds both libraries.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// Shared-memory layout of a tile of R rows of D bf16 values, as `wgmma`
// reads it: D is cut into column blocks of kCols values (128 bytes a row,
// 64 at D = 32); a block holds its R rows back to back, and the 16-byte
// chunks of a row are XOR-swizzled with address bits 7-9 (7-8), the
// hardware's 128-byte (64-byte) swizzle. Tile bases are 1024-byte aligned.
template <int D>
struct Layout {
  static constexpr int kRowBytes = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kCols = kRowBytes / 2;
  static constexpr uint32_t kMask = kRowBytes / 16 - 1;
  static constexpr uint64_t kMode = kRowBytes == 128 ? 1 : 2;  // B128, B64
  static constexpr uint32_t kGroup = 8 * kRowBytes;   // 8 rows (core group)

  template <int R>
  __device__ static __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t off = (uint32_t)(c / kCols) * R * kRowBytes +
                         (uint32_t)r * kRowBytes + (uint32_t)(c % kCols) * 2;
    return off ^ (((off >> 7) & kMask) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// !valid (src is then not read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's completed cp.async writes visible to wgmma, which
// reads shared memory through the async proxy.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of these registers
// across a wgmma's launch or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

}  // namespace hopper
