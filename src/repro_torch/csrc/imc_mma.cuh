// Shared pieces of the INT8 kernels (imc_conv2d.cu, imc_mvm.cu) on Hopper's
// s8 tensor cores: 16-byte cp.async staging, ldmatrix fragment loads, the
// mma.sync m16n8k32 s8 x s8 -> s32 product over a warp tile, and the
// requantization epilogue.
//
// Both operands live in shared memory as K-contiguous rows (A: one row per
// output row, B: one row per output column, i.e. the "col" operand), with
// the row stride an odd number of 16-byte chunks (`row_stride`), so the 8
// row addresses of one ldmatrix phase fall in 8 distinct bank groups.
//
// Fragment layout of m16n8k32 (PTX ISA, "mma.m16n8k32" for .s8), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 32, row): a0 = row g,     k 4t..4t+3;  a1 = row g + 8, same k;
//                     a2 = row g,     k 16+4t..;   a3 = row g + 8, same k.
//   B (32 x 8, col):  b0 = column g,  k 4t..4t+3;  b1 = column g, k 16+4t..
//   C (16 x 8, s32):  c0, c1 = row g, columns 2t, 2t+1; c2, c3 = row g + 8.
// ldmatrix (b16 view) hands lane l word l % 4 of row l / 4 of each 8 x 16-
// byte matrix, which is exactly a0..a3 (b0, b1) above when the matrices are
// (rows 0-7, k 0-15), (rows 8-15, k 0-15), (rows 0-7, k 16-31), (rows 8-15,
// k 16-31) for A and (columns 0-7, k 0-15), (columns 0-7, k 16-31) for B.
// tests/test_torch_kernels.py models this layout in numpy.
//
// The sum is exact: no .satfinite, and |acc| <= 127 * 127 * K stays inside
// int32 for K up to 133,000 (ResNet-18's largest K is 2,304).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace imc {

// Row stride in bytes of a K-contiguous shared-memory row of `bytes`
// (a multiple of 16): the next odd number of 16-byte chunks.
__host__ __device__ constexpr int row_stride(int bytes) {
  return ((bytes / 16) | 1) * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with src_bytes 0 the 16 bytes are zero.
// Cached in L2 only (.cg), or also in L1 (.ca) with kL1.
template <bool kL1 = false>
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  if constexpr (kL1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 32 s8, row) . b (32 x 8 s8, col), exact s32 accumulate
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This lane's ldmatrix address offsets (bytes) within an A tile (rows of
// the 16-row m-tile, then the k half) and a B tile (rows of two 8-column
// n-tiles, then the k half), for rows of stride `ld` bytes.
__device__ __forceinline__ uint32_t a_lane_offset(int lane, int ld) {
  return ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 16 * (lane >> 4);
}
__device__ __forceinline__ uint32_t b_lane_offset(int lane, int ld) {
  return ((lane & 7) + 8 * (lane >> 4)) * ld + 16 * ((lane >> 3) & 1);
}

// One 32-deep step of a warp tile of MI 16-row m-tiles by NI 8-column
// n-tiles (NI even).  a_addr / b_addr: this lane's ldmatrix addresses of
// m-tile 0 / n-tiles 0-1 at the step's first k (shared space), rows LD
// bytes apart.
template <int MI, int NI, int LD>
__device__ __forceinline__ void warp_mma_k32(int (&acc)[MI][NI][4],
                                             uint32_t a_addr, uint32_t b_addr) {
  static_assert(NI % 2 == 0, "n-tiles are loaded in pairs");
  uint32_t a[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) ldsm_x4(a[i], a_addr + i * 16 * LD);
#pragma unroll
  for (int j = 0; j < NI; j += 2) {
    uint32_t b[4];
    ldsm_x4(b, b_addr + j * 8 * LD);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      mma_s8(acc[i][j], a[i], b[0], b[1]);
      mma_s8(acc[i][j + 1], a[i], b[2], b[3]);
    }
  }
}

// (acc * sx) * sw + b, each step rounded to nearest on its own (no FMA), as
// the plain PyTorch version computes it one elementwise op at a time.
__device__ __forceinline__ float requant(int acc, float sx, float sw,
                                         float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc), sx), sw), b);
}

}  // namespace imc
