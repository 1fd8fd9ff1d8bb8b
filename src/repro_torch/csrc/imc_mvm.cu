// INT8 weight-stationary matrix multiply with fused requantization, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `imc_mvm` (src/repro/kernels/imc_mvm.py,
// body `_imc_mvm_kernel`): out[m, n] = (acc[m, n] * sx) * sw[n] + bias[n]
// with acc = sum_k qx[m, k] * qw[k, n] accumulated exactly in int32.
//
// What bounds it on the H100: on the model's fc node, (B, 256) x (256, 10),
// the work is tiny (0.66 M MAC per 256 frames) and the call is bound by
// launch latency and the bytes it moves; at large M, N, K it would be bound
// by integer multiply-add issue rate, since __dp4a runs on the CUDA cores
// at a small fraction of the int8 tensor-core peak.
//
// Design: each block owns one 64 x 64 output tile and walks K in chunks of
// 32 int8 values staged in shared memory, zero-filled past K, M and N, so
// no padded copy of either operand is made in device memory (the TPU
// kernel pads both to 128-multiples in HBM).  Each chunk is stored as
// packed 4-byte words along K; each of 256 threads accumulates a 4 x 4
// sub-tile with __dp4a on those words.  Rows are padded to 9 words so that
// the word reads of a warp fall on distinct banks.  The epilogue rounds
// each step separately (__fmul_rn/__fadd_rn): an FMA would differ in the
// last bit from the plain PyTorch version, which runs one elementwise op at
// a time.  Tensor cores (mma.sync / wgmma s8), TMA and pipelining are
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;              // int8 values per K chunk
constexpr int kWords = kBK / 4;      // packed words per chunk
constexpr int kLds = kWords + 1;     // shared row stride in words
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
imc_mvm_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qw,
               const float* __restrict__ sx, const float* __restrict__ sw,
               const float* __restrict__ bias, float* __restrict__ out,
               int M, int K, int N) {
  __shared__ int32_t a_s[kBM * kLds];  // a_s[m][w]: qx[m0+m][k0+4w .. +3]
  __shared__ int32_t b_s[kBN * kLds];  // b_s[n][w]: qw[k0+4w .. +3][n0+n]
  int8_t* a8 = reinterpret_cast<int8_t*>(a_s);
  int8_t* b8 = reinterpret_cast<int8_t*>(b_s);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // consecutive threads read consecutive k of one row of qx
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int m = m0 + r, k = k0 + c;
      a8[r * kLds * 4 + c] =
          (m < M && k < K) ? qx[static_cast<long long>(m) * K + k] : 0;
    }
    // consecutive threads read consecutive n of one row of qw
    for (int i = tid; i < kBN * kBK; i += kThreads) {
      const int c = i % kBN, r = i / kBN;
      const int n = n0 + c, k = k0 + r;
      b8[c * kLds * 4 + r] =
          (n < N && k < K) ? qw[static_cast<long long>(k) * N + n] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[(ty + 16 * i) * kLds + w];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[(tx + 16 * j) * kLds + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float s = *sx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      out[static_cast<long long>(m) * N + n] = __fadd_rn(
          __fmul_rn(__fmul_rn(static_cast<float>(acc[i][j]), s), sw[n]),
          bias[n]);
    }
  }
}

}  // namespace

// qx (M, K) int8 row-major, qw (K, N) int8 row-major, sx one float on the
// device, sw and bias (N,) float, out (M, N) float.  Returns the CUDA error
// of the launch (0 when it was accepted).
extern "C" int imc_mvm_launch(const int8_t* qx, const int8_t* qw,
                              const float* sx, const float* sw,
                              const float* bias, float* out, int M, int K,
                              int N, cudaStream_t stream) {
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  imc_mvm_kernel<<<grid, kThreads, 0, stream>>>(qx, qw, sx, sw, bias, out, M,
                                                K, N);
  return static_cast<int>(cudaGetLastError());
}
