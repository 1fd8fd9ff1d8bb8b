// INT8 convolution with fused requantization as an implicit GEMM over
// NHWC, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `imc_conv2d` (src/repro/kernels/conv2d.py,
// body `_conv_kernel`): out[b, oh, ow, co] = (acc * sx) * sw[co] + bias[co]
// with acc the exact int32 sum over taps (kh, kw) and input channels ci of
// x[b, oh*s - pad_top + kh, ow*s - pad_left + kw, ci] * w[kh, kw, ci, co],
// zero outside the input.  The TPU kernel pads the input in HBM, keeps one
// image and a Cout block in VMEM and is limited to maps of at most 64 x 64;
// this one gathers taps on the fly and takes any spatial size and any
// explicit padding (SAME split floor/ceil as XLA, or VALID).
//
// What bounds it on the H100: at ResNet-18-CIFAR's shapes, batch 256, the
// bytes (int8 input once, float32 output once) take longer at 3.35 TB/s
// than the int8 operations take at the tensor-core peak, so the ideal is
// memory bound; this first version is bound instead by __dp4a issue rate
// on the CUDA cores, a small fraction of the tensor-core peak.
//
// Design: GEMM with M = B*Ho*Wo output pixels, N = Cout, K = KH*KW*Cin in
// HWIO order.  The wrapper repacks the weights once to [Cout][K rounded up
// to 4] int8 (zero tail; the stem has K = 27), read here as 4-byte words.
// Each block owns a 64-pixel x 64-channel tile and walks K in chunks of 8
// words (32 int8 values) staged in shared memory.  Each word of the input
// chunk is gathered from the pixel's receptive field: with Cin % 4 == 0 the
// 4 values lie in one tap and are one aligned 32-bit load; otherwise
// (Cin = 3 at the stem) they are gathered byte by byte.  Rows of the
// shared tiles are padded by 4 words so stores of a warp hit distinct
// banks.  Each of 256 threads accumulates a 4 x 4 sub-tile with __dp4a.
// The epilogue rounds each step separately (__fmul_rn/__fadd_rn) to match
// the plain PyTorch version bit for bit.  Tensor cores, TMA and
// pipelining are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;              // output pixels per block
constexpr int kBN = 64;              // output channels per block
constexpr int kWords = 8;            // packed K words per chunk
constexpr int kPad = 4;
constexpr int kThreads = 256;

struct ConvShape {
  int B, H, W, Cin, Ho, Wo, Cout, KW, stride, pad_t, pad_l, K, Kw;
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
imc_conv2d_kernel(const int8_t* __restrict__ x, const int32_t* __restrict__ wp,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  const float* __restrict__ bias, float* __restrict__ out,
                  const ConvShape p) {
  __shared__ int32_t a_s[kWords][kBM + kPad];  // a_s[w][m]
  __shared__ int32_t b_s[kWords][kBN + kPad];  // b_s[w][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long M = static_cast<long long>(p.B) * p.Ho * p.Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // This thread stages word (tid % 8) of rows tid / 8 and tid / 8 + 32 of
  // both tiles; the pixel of each staged row is decoded once.
  const int wsel = tid % kWords;
  const int row0 = tid / kWords;
  bool valid[2];
  int ih0[2], iw0[2];
  long long base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long m = m0 + row0 + 32 * r;
    valid[r] = m < M;
    const long long mm = valid[r] ? m : 0;
    const int ow = static_cast<int>(mm % p.Wo);
    const int oh = static_cast<int>((mm / p.Wo) % p.Ho);
    const long long b = mm / (static_cast<long long>(p.Wo) * p.Ho);
    ih0[r] = oh * p.stride - p.pad_t;
    iw0[r] = ow * p.stride - p.pad_l;
    base[r] = b * p.H * p.W * p.Cin;
  }

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0w = 0; k0w < p.Kw; k0w += kWords) {
    const int kword = k0w + wsel;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int v = 0;
      if (valid[r] && kword < p.Kw) {
        if (kVec) {
          const int k = kword * 4;
          const int tap = k / p.Cin;
          const int ci = k - tap * p.Cin;
          const int ih = ih0[r] + tap / p.KW;
          const int iw = iw0[r] + tap % p.KW;
          if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
            v = *reinterpret_cast<const int32_t*>(
                x + base[r] + (static_cast<long long>(ih) * p.W + iw) * p.Cin +
                ci);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = kword * 4 + e;
            if (k >= p.K) break;
            const int tap = k / p.Cin;
            const int ci = k - tap * p.Cin;
            const int ih = ih0[r] + tap / p.KW;
            const int iw = iw0[r] + tap % p.KW;
            if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) {
              const int8_t q =
                  x[base[r] + (static_cast<long long>(ih) * p.W + iw) * p.Cin +
                    ci];
              v |= static_cast<int>(static_cast<uint8_t>(q)) << (8 * e);
            }
          }
        }
      }
      a_s[wsel][row0 + 32 * r] = v;
      const int n = n0 + row0 + 32 * r;
      b_s[wsel][row0 + 32 * r] =
          (n < p.Cout && kword < p.Kw)
              ? wp[static_cast<long long>(n) * p.Kw + kword]
              : 0;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[w][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[w][tx + 16 * j];
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
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= p.Cout) continue;
      out[m * p.Cout + n] = __fadd_rn(
          __fmul_rn(__fmul_rn(static_cast<float>(acc[i][j]), s), sw[n]),
          bias[n]);
    }
  }
}

}  // namespace

// x (B, H, W, Cin) int8 NHWC; wp (Cout, Kw) packed words of the HWIO
// weights flattened to K = KH*KW*Cin and zero-padded to 4*Kw; sx one float
// on the device; sw and bias (Cout,) float; out (B, Ho, Wo, Cout) float.
// `vec` selects 32-bit input loads and needs Cin % 4 == 0 and a 4-byte
// aligned x.  Returns the CUDA error of the launch (0 when accepted).
extern "C" int imc_conv2d_launch(const int8_t* x, const int32_t* wp,
                                 const float* sx, const float* sw,
                                 const float* bias, float* out, int B, int H,
                                 int W, int Cin, int Ho, int Wo, int Cout,
                                 int KW, int stride, int pad_t, int pad_l,
                                 int K, int Kw, int vec, cudaStream_t stream) {
  const ConvShape p{B, H, W, Cin, Ho, Wo, Cout, KW, stride, pad_t, pad_l, K, Kw};
  const long long M = static_cast<long long>(B) * Ho * Wo;
  dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), (Cout + kBN - 1) / kBN);
  if (vec)
    imc_conv2d_kernel<true><<<grid, kThreads, 0, stream>>>(x, wp, sx, sw, bias,
                                                           out, p);
  else
    imc_conv2d_kernel<false><<<grid, kThreads, 0, stream>>>(x, wp, sx, sw,
                                                            bias, out, p);
  return static_cast<int>(cudaGetLastError());
}
