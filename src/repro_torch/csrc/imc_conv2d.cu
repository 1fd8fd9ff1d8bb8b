// INT8 convolution with fused requantization as an implicit GEMM over
// NHWC on Hopper's s8 tensor cores (sm_90a).
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
// bytes (int8 input once, float32 output once; the output is ~78% of them)
// take longer at 3.35 TB/s than the int8 operations at the tensor-core
// peak, so the ideal is memory bound.  This kernel stays above that bound
// by the latency of staging its operands (the cp.async round trip a stage
// waits on), not by mma.sync's rate nor by the bytes it moves; PERF.md
// keeps the measurements.
//
// Design: GEMM with M = B*Ho*Wo output pixels, N = Cout, K = KH*KW*Cin in
// HWIO order, padded with zeros to Kpad, a multiple of 32.  The wrapper
// packs the weights on every call to (Cout, Kpad) int8 (`pack_weight`):
// K-contiguous rows, already the "col" B operand.  Output tiles are BM pixels x BN
// channels; warps own 32 x 32 sub-tiles (2 x 4 mma tiles, 32 int32
// accumulators a thread) and run imc::warp_mma_k32 (imc_mma.cuh).  K is
// staged kBKS bytes a stage (kBKS / 32 m16n8k32 steps; a last stage may be
// part used) in a ring of kStages stages in dynamic shared memory,
// kStages - 1 of them in flight: rows at a stride of an odd number of
// 16-byte chunks (80 bytes for 64, 144 for 128), so ldmatrix phases are
// free of bank conflicts.
//
// The grid is persistent: as many blocks as fit on the card at once, each
// walking the tiles blockIdx.x, + gridDim.x, ... as one stream of stages,
// so the loads of a tile's first stages are in flight while the previous
// tile is computed and stored: with K as short as stage 1's (288, 4.5
// stages), one tile a block would pay the ring's fill latency on every
// tile.
//
// Instances (`imc_conv2d_instance`, mirrored by `conv_instance` in
// kernels/conv2d.py), by the N tile and the staging:
//
// * N tile by Cout: 32 (Cout <= 32: the stem and stage 1, no wasted mma),
//   64 (Cout <= 64) or 128.  N tiles 32 and 64: BM 128 (4 and 8 warps),
//   64-byte stages, 4 deep (3 and 2 blocks an SM).  N tile 128: BM 64 (8
//   warps), 128-byte stages, 3 deep (1 block an SM), for the long K of
//   stages 3 and 4 (up to 2,304): stage 4 (M = 4,096, Cout 256) has 128
//   tiles, stage 3 (M = 16,384) 256, stage 1 (M = 262,144) 2,048.  Deeper
//   rings cost blocks an SM and were slower on the H100; 128-byte stages
//   paid off on stage 4's long K and not on stage 1's short one.
// * cp.async staging where Cin % 16 == 0 and x is 16-byte aligned: each
//   16-byte piece of a pixel's im2col row then lies within one tap, and is
//   one cp.async (zero-filled outside the input, past K and past M), cached
//   in L1 (.ca: the 9 taps of a 3x3 conv read each input pixel 9 times, and
//   neighbouring pixels of a tile share most of them; .cg, L2 only, was
//   slower on the H100).  A thread stages one piece column of a few rows,
//   so it decodes the tap once a stage and each row's pixel once a tile.
//   Every ResNet-18 layer but the stem.
// * gather staging otherwise (the stem's Cin = 3, K = 27 in one 32-chunk;
//   odd Cin; an unaligned x): a thread gathers consecutive bytes of one
//   im2col row, its tap advancing with k without a division, into 32-bit
//   words stored to shared memory; the weights still come by cp.async, and
//   the product is the same tensor-core loop.
//
// Pixel indices are 32-bit, for cheap division: the launch refuses M above
// INT_MAX - 128, so that a tile's rows m0 + r (r < BM <= 128) and the tile
// count's rounding (M + BM - 1) cannot wrap.
//
// Epilogue: each accumulator is requantized with separate roundings
// (imc::requant, bit-equal to the plain PyTorch version) into a BM x BN
// float32 tile in its own shared memory (rows of BN + 8 floats,
// conflict-free for the fragments' float2 writes), then stored 16 bytes a
// thread along the Cout-contiguous NHWC rows.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "imc_mma.cuh"

namespace {

struct ConvShape {
  int B, H, W, Cin, Ho, Wo, Cout, KW, stride, pad_t, pad_l, K, Kpad, M;
};

// Block shape of the instance with N tile BN: BM pixels, WARPS_M x WARPS_N
// warps, kThreads threads; K staged kBKS bytes a stage (kSteps m16n8k32
// steps, rows kLd bytes apart) in a ring of kStages stages.
template <int BM_, int WARPS_M_, int WARPS_N_, int BKS_, int STAGES_>
struct TileShape {
  static constexpr int BM = BM_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int kThreads = WARPS_M_ * WARPS_N_ * 32;
  static constexpr int kBKS = BKS_, kSteps = BKS_ / 32;
  static constexpr int kLd = imc::row_stride(BKS_);
  static constexpr int kStages = STAGES_;
};
template <int BN>
struct Tile;
template <>
struct Tile<32> : TileShape<128, 4, 1, 64, 4> {};
template <>
struct Tile<64> : TileShape<128, 4, 2, 64, 4> {};
template <>
struct Tile<128> : TileShape<64, 2, 4, 128, 3> {};

template <int BN>
__host__ __device__ constexpr int ring_bytes() {
  return Tile<BN>::kStages * (Tile<BN>::BM + BN) * Tile<BN>::kLd;
}

// Dynamic shared memory of the instance: the ring, then the f32 output tile
// (rows of BN + 8 floats).
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<BN>() + Tile<BN>::BM * (BN + 8) * 4;
}

// The receptive field's origin (ih0, iw0) and the image's offset in x of
// output pixel m (< M, which the launch keeps below 2^31).
struct Pixel {
  int ih0, iw0;
  long long base;
};

__device__ __forceinline__ Pixel decode_pixel(int m, const ConvShape& p) {
  const int ow = m % p.Wo;
  const int q = m / p.Wo;
  const int oh = q % p.Ho;
  const int b = q / p.Ho;
  return {oh * p.stride - p.pad_t, ow * p.stride - p.pad_l,
          static_cast<long long>(b) * p.H * p.W * p.Cin};
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
imc_conv2d_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  const float* __restrict__ bias, float* __restrict__ out,
                  const ConvShape p) {
  constexpr int BM = Tile<BN>::BM;
  constexpr int WARPS_M = Tile<BN>::WARPS_M;
  constexpr int kThreads = Tile<BN>::kThreads;
  constexpr int kStages = Tile<BN>::kStages;
  constexpr int kBKS = Tile<BN>::kBKS;
  constexpr int kSteps = Tile<BN>::kSteps;
  constexpr int kLd = Tile<BN>::kLd;
  constexpr int WM = BM / WARPS_M;             // warp tile WM x WN
  constexpr int WN = BN / Tile<BN>::WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int kStageBytes = (BM + BN) * kLd;
  constexpr int kLdOut = BN + 8;               // floats
  constexpr int kChunks = kBKS / 16;           // 16-byte pieces of a row
  // cp.async staging: a thread keeps one piece column and kAPer rows
  constexpr int kAPer = BM * kChunks / kThreads;
  constexpr int kARowStep = kThreads / kChunks;
  constexpr int kBPer = (BN * kChunks + kThreads - 1) / kThreads;
  // gather staging: a thread owns kGWords consecutive words of one row
  constexpr int kGWords = BM * (kBKS / 4) / kThreads;
  constexpr int kGThreadsPerRow = (kBKS / 4) / kGWords;
  static_assert(kAPer * kThreads == BM * kChunks, "A pieces split evenly");
  static_assert(kGThreadsPerRow * kGWords == kBKS / 4, "rows split evenly");
  extern __shared__ __align__(16) unsigned char smem[];
  float* o_s = reinterpret_cast<float*>(smem + ring_bytes<BN>());

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;
  const int KS = p.Kpad / kBKS + (p.Kpad % kBKS != 0);   // stages a tile
  const int tiles_n = (p.Cout + BN - 1) / BN;
  const int tiles = (p.M + BM - 1) / BM * tiles_n;
  const int my_tiles =
      static_cast<int>(blockIdx.x) < tiles
          ? (tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
          : 0;
  const int F = my_tiles * KS;                 // this block's stages

  // Loader state: the tile being staged and the pixels of this thread's
  // rows in it, decoded once a tile.
  constexpr int kRows = VEC ? kAPer : 1;
  Pixel px[kRows];
  bool row_ok[kRows];
  int ld_j = -1, ld_n0 = 0;

  auto load_stage = [&](int buf, int f) {
    const int j = f / KS;
    const int ks = f - j * KS;
    if (j != ld_j) {
      const int tile = blockIdx.x + j * gridDim.x;
      const int m0 = tile / tiles_n * BM;
      ld_j = j;
      ld_n0 = tile % tiles_n * BN;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r =
            VEC ? tid / kChunks + i * kARowStep : tid / kGThreadsPerRow;
        row_ok[i] = m0 + r < p.M;
        px[i] = decode_pixel(row_ok[i] ? m0 + r : 0, p);
      }
    }
    unsigned char* a_s = smem + buf * kStageBytes;
    unsigned char* b_s = a_s + BM * kLd;
    const int k0 = ks * kBKS;
    if constexpr (VEC) {
      // one tap decode a stage: every piece of this thread has the same k
      const int c = tid % kChunks;
      const int k = k0 + 16 * c;
      const int tap = k / p.Cin;
      const int ci = k - tap * p.Cin;
      const int kh = tap / p.KW;
      const int kw = tap - kh * p.KW;
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const int r = tid / kChunks + i * kARowStep;
        const int ih = px[i].ih0 + kh;
        const int iw = px[i].iw0 + kw;
        const bool in = row_ok[i] && k < p.K && ih >= 0 && ih < p.H &&
                        iw >= 0 && iw < p.W;
        imc::cp_async16<true>(
            imc::smem_u32(a_s + r * kLd + 16 * c),
            in ? x + px[i].base + (static_cast<long long>(ih) * p.W + iw) *
                                       p.Cin + ci
               : x,
            in ? 16 : 0);
      }
    } else {
      // kGWords words of one row, byte by byte; the tap advances with k
      const int r = tid / kGThreadsPerRow;
      const int kb = k0 + 4 * kGWords * (tid % kGThreadsPerRow);
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          a_s + r * kLd + 4 * kGWords * (tid % kGThreadsPerRow));
      const bool any = row_ok[0] && kb < p.K;
      int tap = any ? kb / p.Cin : 0;
      int ci = kb - tap * p.Cin;
      int kh = tap / p.KW;
      int kw = tap - kh * p.KW;
      const int8_t* xb = x + px[0].base;
      for (int w = 0; w < kGWords; ++w) {
        uint32_t v = 0;
        if (any && kb + 4 * w < p.K) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ih = px[0].ih0 + kh;
            const int iw = px[0].iw0 + kw;
            if (kb + 4 * w + e < p.K && ih >= 0 && ih < p.H && iw >= 0 &&
                iw < p.W)
              v |= static_cast<uint32_t>(static_cast<uint8_t>(
                       xb[(static_cast<long long>(ih) * p.W + iw) * p.Cin +
                          ci]))
                   << (8 * e);
            if (++ci == p.Cin) {
              ci = 0;
              if (++kw == p.KW) {
                kw = 0;
                ++kh;
              }
            }
          }
        }
        dst[w] = v;
      }
    }
    // weights: BN rows of the packed (Cout, Kpad) matrix, zero past Cout
    // and past Kpad (a last stage may be half used)
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int idx = tid + i * kThreads;
      if (idx >= BN * kChunks) break;
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const int n = ld_n0 + r;
      const int k = k0 + 16 * c;
      const bool ok = n < p.Cout && k < p.Kpad;
      imc::cp_async16(imc::smem_u32(b_s + r * kLd + 16 * c),
                      ok ? wp + static_cast<long long>(n) * p.Kpad + k : wp,
                      ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < F) load_stage(s, s);
    imc::cp_async_commit();
  }

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const uint32_t smem0 = imc::smem_u32(smem);
  const uint32_t a_addr =
      smem0 + wm * WM * kLd + imc::a_lane_offset(lane, kLd);
  const uint32_t b_addr =
      smem0 + (BM + wn * WN) * kLd + imc::b_lane_offset(lane, kLd);
  const float s = *sx;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool vec4 = p.Cout % 4 == 0;

  for (int f = 0; f < F; ++f) {
    imc::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage f landed; every warp is done with f - 1
    const int nf = f + kStages - 1;
    if (nf < F) load_stage(nf % kStages, nf);
    imc::cp_async_commit();
    const int j = f / KS;
    const int ks = f - j * KS;
    const uint32_t off = (f % kStages) * kStageBytes;
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      if (ks * kBKS + 32 * st < p.Kpad)
        imc::warp_mma_k32<MI, NI, kLd>(acc, a_addr + off + 32 * st,
                                       b_addr + off + 32 * st);
    if (ks != KS - 1) continue;

    // epilogue of tile j: requantize into o_s, then 16-byte stores
    const int tile = blockIdx.x + j * gridDim.x;
    const int m0 = tile / tiles_n * BM;
    const int n0 = tile % tiles_n * BN;
#pragma unroll
    for (int jn = 0; jn < NI; ++jn) {
      const int col = wn * WN + 8 * jn + 2 * t;
      const int n = n0 + col;
      const float sw0 = n < p.Cout ? sw[n] : 0.0f;
      const float sw1 = n + 1 < p.Cout ? sw[n + 1] : 0.0f;
      const float b0 = n < p.Cout ? bias[n] : 0.0f;
      const float b1 = n + 1 < p.Cout ? bias[n + 1] : 0.0f;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = wm * WM + 16 * i + g;
        *reinterpret_cast<float2*>(o_s + row * kLdOut + col) =
            make_float2(imc::requant(acc[i][jn][0], s, sw0, b0),
                        imc::requant(acc[i][jn][1], s, sw1, b1));
        *reinterpret_cast<float2*>(o_s + (row + 8) * kLdOut + col) =
            make_float2(imc::requant(acc[i][jn][2], s, sw0, b0),
                        imc::requant(acc[i][jn][3], s, sw1, b1));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0;
      }
    }
    __syncthreads();  // o_s is written; the next tile's epilogue comes
                      // after at least one more barrier at the loop's top
    constexpr int C4 = BN / 4;
    for (int idx = tid; idx < BM * C4; idx += kThreads) {
      const int r = idx / C4;
      const int c = (idx - r * C4) * 4;
      const int m = m0 + r;
      const int n = n0 + c;
      if (m >= p.M || n >= p.Cout) continue;
      const float* src = o_s + r * kLdOut + c;
      float* dst = out + static_cast<long long>(m) * p.Cout + n;
      if (vec4) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < p.Cout) dst[e] = src[e];
      }
    }
  }
  imc::cp_async_wait<0>();
}

// Blocks of the instance that fit on device `dev` at once (the shared
// memory attribute is set on first use per device).
template <int BN, bool VEC>
int resident_blocks(int dev, int* blocks) {
  static int cached_dev = -1, cached = 0;
  if (cached_dev == dev) {
    *blocks = cached;
    return 0;
  }
  constexpr int smem = smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(
      imc_conv2d_kernel<BN, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, imc_conv2d_kernel<BN, VEC>, Tile<BN>::kThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cached = per_sm * sms;
  cached_dev = dev;
  *blocks = cached;
  return 0;
}

template <int BN, bool VEC>
int launch(const int8_t* x, const int8_t* wp, const float* sx, const float* sw,
           const float* bias, float* out, const ConvShape& p,
           cudaStream_t stream) {
  constexpr int BM = Tile<BN>::BM;
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = resident_blocks<BN, VEC>(dev, &resident);
  if (rc != 0) return rc;
  const long long tiles = (static_cast<long long>(p.M) + BM - 1) / BM *
                          ((p.Cout + BN - 1) / BN);
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  imc_conv2d_kernel<BN, VEC>
      <<<grid, Tile<BN>::kThreads, smem_bytes<BN>(), stream>>>(x, wp, sx, sw,
                                                               bias, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which instance serves (Cin, Cout, aligned x): 0-2 cp.async staging with
// N tile 32, 64, 128; 3-5 gather staging with N tile 32, 64, 128; -1 none.
// The one place the rule lives; mirrored by conv_instance in
// kernels/conv2d.py (chip_smoke.py holds the two together on the card).
extern "C" int imc_conv2d_instance(int Cin, int Cout, int aligned) {
  if (Cin <= 0 || Cout <= 0) return -1;
  const int tile = Cout <= 32 ? 0 : Cout <= 64 ? 1 : 2;
  return (aligned && Cin % 16 == 0 ? 0 : 3) + tile;
}

// x (B, H, W, Cin) int8 NHWC; wp (Cout, Kpad) int8, the HWIO weights
// flattened to K = KH*KW*Cin per output channel and zero-padded to Kpad =
// 4*Kw, a multiple of 32 (read here as bytes; Kw counts 4-byte words); sx
// one float on the device; sw and bias (Cout,) float; out (B, Ho, Wo, Cout)
// float.  `aligned`: x is 16-byte aligned (checked).  Returns the CUDA
// error of the launch (0 when accepted).
extern "C" int imc_conv2d_launch(const int8_t* x, const int32_t* wp,
                                 const float* sx, const float* sw,
                                 const float* bias, float* out, int B, int H,
                                 int W, int Cin, int Ho, int Wo, int Cout,
                                 int KW, int stride, int pad_t, int pad_l,
                                 int K, int Kw, int aligned,
                                 cudaStream_t stream) {
  const int Kpad = 4 * Kw;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  if (B <= 0 || Ho <= 0 || Wo <= 0 || M > INT_MAX - 128 || Kpad % 32 != 0 ||
      Kpad < K || (aligned && reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvShape p{B,  H,      W,     Cin,   Ho, Wo,   Cout,
                    KW, stride, pad_t, pad_l, K,  Kpad, static_cast<int>(M)};
  const int8_t* w8 = reinterpret_cast<const int8_t*>(wp);
  switch (imc_conv2d_instance(Cin, Cout, aligned)) {
    case 0: return launch<32, true>(x, w8, sx, sw, bias, out, p, stream);
    case 1: return launch<64, true>(x, w8, sx, sw, bias, out, p, stream);
    case 2: return launch<128, true>(x, w8, sx, sw, bias, out, p, stream);
    case 3: return launch<32, false>(x, w8, sx, sw, bias, out, p, stream);
    case 4: return launch<64, false>(x, w8, sx, sw, bias, out, p, stream);
    case 5: return launch<128, false>(x, w8, sx, sw, bias, out, p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
