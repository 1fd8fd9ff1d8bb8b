// INT8 weight-stationary matrix multiply with fused requantization on
// Hopper's s8 tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel `imc_mvm` (src/repro/kernels/imc_mvm.py,
// body `_imc_mvm_kernel`): out[m, n] = (acc[m, n] * sx) * sw[n] + bias[n]
// with acc = sum_k qx[m, k] * qw[k, n] accumulated exactly in int32.
//
// What bounds it on the H100: on the model's fc node, (B, 256) x (256, 10),
// the work is tiny (0.66 M MAC per 256 frames) and the call is bound by
// launch latency and one round of loads; at large M, N, K it would be bound
// by the tensor cores' int8 rate.
//
// Design: mma.sync m16n8k32 s8 -> s32 (imc_mma.cuh).  A block owns a 16-row
// x 32-column output tile, so the fc node of a 256-frame request spreads
// over 16 blocks, and walks K 128 bytes a stage through a two-stage ring in
// shared memory; each of its 4 warps takes one 32-deep slice of a stage
// (split K inside the block) and the 4 partial int32 tiles are summed in
// shared memory before the epilogue (integer sums: exact in any order).
// Rows are K-contiguous at a 144-byte stride (9 16-byte chunks, odd, so
// ldmatrix phases are free of bank conflicts).  qx rows are staged by
// 16-byte cp.async where K % 16 == 0 and qx is 16-byte aligned (zero-filled
// past M and K); otherwise (the gather instance, e.g. K = 129) byte by
// byte.  qw comes row-major (K, N) as the reference takes it and is
// transposed on the way into shared memory: each thread gathers 4
// consecutive k of one column into a 32-bit word, lanes spread over 8
// columns x 4 words so the word stores hit 32 distinct banks.  No padded
// copy of either operand is made in device memory (the TPU kernel pads both
// to 128-multiples in HBM).  The epilogue rounds each step separately
// (imc::requant): an FMA would differ in the last bit from the plain
// PyTorch version, which runs one elementwise op at a time.

#include <cstdint>
#include <cuda_runtime.h>

#include "imc_mma.cuh"

namespace {

constexpr int kBM = 16;
constexpr int kBN = 32;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 32 * kWarps;                // K bytes per stage
constexpr int kLd = imc::row_stride(kBK);       // 144
constexpr int kStageBytes = (kBM + kBN) * kLd;
constexpr int kLdRed = kBN + 1;                 // ints, partial-sum rows
constexpr int kRing = 2 * kStageBytes;
constexpr int kRed = kWarps * kBM * kLdRed * 4;
constexpr int kSmem = kRing > kRed ? kRing : kRed;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
imc_mvm_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qw,
               const float* __restrict__ sx, const float* __restrict__ sw,
               const float* __restrict__ bias, float* __restrict__ out,
               int M, int K, int N) {
  __shared__ __align__(16) unsigned char smem[kSmem];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int KT = (K + kBK - 1) / kBK;

  auto load_stage = [&](int buf, int kt) {
    unsigned char* a_s = smem + buf * kStageBytes;
    unsigned char* b_s = a_s + kBM * kLd;
    const int k0 = kt * kBK;
    // A: 16 rows x 8 pieces of 16 bytes, one piece a thread
    {
      const int r = tid >> 3;
      const int c = tid & 7;
      const int m = m0 + r;
      const int k = k0 + 16 * c;
      unsigned char* dst = a_s + r * kLd + 16 * c;
      if constexpr (VEC) {
        const bool ok = m < M && k < K;
        imc::cp_async16(imc::smem_u32(dst),
                        ok ? qx + static_cast<long long>(m) * K + k : qx,
                        ok ? 16 : 0);
      } else {
        uint32_t v[4] = {0, 0, 0, 0};
        if (m < M) {
          const int8_t* row = qx + static_cast<long long>(m) * K;
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (k + e < K)
              v[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[k + e]))
                           << (8 * (e & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    // B: qw[k0 .. k0 + 128, n0 .. n0 + 32] transposed to 32 rows of 32
    // words; lanes cover 8 columns x 4 words, warps and iterations the rest
#pragma unroll
    for (int it = 0; it < kBN * (kBK / 4) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int rest = idx >> 5;
      const int n = (idx & 7) + 8 * (rest & 3);
      const int w = ((idx >> 3) & 3) + 4 * (rest >> 2);
      const int col = n0 + n;
      const int k = k0 + 4 * w;
      uint32_t v = 0;
      if (col < N) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < K)
            v |= static_cast<uint32_t>(static_cast<uint8_t>(
                     qw[static_cast<long long>(k + e) * N + col]))
                 << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(b_s + n * kLd + 4 * w) = v;
    }
  };

  int acc[1][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0;

  const uint32_t smem0 = imc::smem_u32(smem);
  const uint32_t a_addr = smem0 + 32 * warp + imc::a_lane_offset(lane, kLd);
  const uint32_t b_addr =
      smem0 + kBM * kLd + 32 * warp + imc::b_lane_offset(lane, kLd);

  load_stage(0, 0);
  imc::cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    imc::cp_async_wait<0>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    if (kt + 1 < KT) load_stage((kt + 1) & 1, kt + 1);
    imc::cp_async_commit();
    const uint32_t off = (kt & 1) * kStageBytes;
    imc::warp_mma_k32<1, 4, kLd>(acc, a_addr + off, b_addr + off);
  }
  imc::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the partial sums

  int* red = reinterpret_cast<int*>(smem) + warp * kBM * kLdRed;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = 8 * j + 2 * t;
    red[g * kLdRed + col] = acc[0][j][0];
    red[g * kLdRed + col + 1] = acc[0][j][1];
    red[(g + 8) * kLdRed + col] = acc[0][j][2];
    red[(g + 8) * kLdRed + col + 1] = acc[0][j][3];
  }
  __syncthreads();

  const int* red0 = reinterpret_cast<const int*>(smem);
  const float s = *sx;
  for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
    const int r = idx / kBN;
    const int c = idx - r * kBN;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red0[(w * kBM + r) * kLdRed + c];
    out[static_cast<long long>(m) * N + n] = imc::requant(sum, s, sw[n], bias[n]);
  }
}

}  // namespace

// Which instance serves (K, aligned qx): 0 cp.async staging of qx, 1 byte
// staging; -1 none.  Mirrored by mvm_instance in kernels/imc_mvm.py.
extern "C" int imc_mvm_instance(int K, int aligned) {
  if (K <= 0) return -1;
  return aligned && K % 16 == 0 ? 0 : 1;
}

// qx (M, K) int8 row-major, qw (K, N) int8 row-major, sx one float on the
// device, sw and bias (N,) float, out (M, N) float.  Returns the CUDA error
// of the launch (0 when it was accepted).
extern "C" int imc_mvm_launch(const int8_t* qx, const int8_t* qw,
                              const float* sx, const float* sw,
                              const float* bias, float* out, int M, int K,
                              int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = reinterpret_cast<uintptr_t>(qx) % 16 == 0;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  switch (imc_mvm_instance(K, aligned)) {
    case 0:
      imc_mvm_kernel<true><<<grid, kThreads, 0, stream>>>(qx, qw, sx, sw, bias,
                                                          out, M, K, N);
      break;
    case 1:
      imc_mvm_kernel<false><<<grid, kThreads, 0, stream>>>(qx, qw, sx, sw,
                                                           bias, out, M, K, N);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
