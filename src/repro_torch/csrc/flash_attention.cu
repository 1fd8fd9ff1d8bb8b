// Flash attention (online softmax, O(S) memory) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`): for each
// (batch, head) and query row, softmax over the keys of
// s = (q . k) * scale, tanh-softcapped before masking, with the masks
// causal (q - k >= 0), window (q - k < window) and padded keys (k < S);
// masked logits are -1e30 (not -inf), the denominator is clamped at 1e-30
// and the output is float32.  All arithmetic is float32, on inputs given in
// float32 or bfloat16 (upcast on read from shared memory).
//
// What bounds it on the H100: at the serving path's shapes (gemma3-1b
// prefill, B = 4, H = 4, S = 2048, hd = 288) the work is 4 * hd FLOP per
// unmasked (q, k) pair, about 39 GFLOP for a global layer: at the
// 989 TFLOP/s bf16 tensor-core rate that is 0.04 ms, above the time to
// move q, k, v and the f32 output once.  This kernel does its products on
// the CUDA cores in float32 (67 TFLOP/s peak, and less since every product
// needs shared-memory reads), so it is bound by float32 issue rate, far
// from that bound.  It is the simple version that is right first;
// wgmma/TMA is later work.
//
// Design: one block of 256 threads per (b * h, 64-row query tile).  The
// query tile stays in shared memory; the loop walks 32-row key tiles,
// staged in shared memory in the inputs' dtype (a 64 x 288 tile is
// 36.9 KB in bf16, 73.7 KB in f32, so f32 staging of Q, K and V at 64 rows
// would not fit), with rows padded to an odd number of 32-bit words so the
// 16 rows a half-warp reads at one column fall on distinct banks.  Thread
// (ty, tx) computes logits for query rows 4ty..4ty+3 and key columns tx and
// tx + 16, and owns the output rows 4ty..4ty+3 at head columns tx + 16j:
// the 16 threads that share a row are one half-warp, so the row max and sum
// are shuffle reductions, and running max, denominator and accumulator
// stay in registers.  Probabilities go through a 64 x 33 f32 tile in
// shared memory for P . V.  Key tiles that lie wholly outside the causal
// band or the window for every row of the query tile are skipped: their
// probabilities are exactly zero once a row has seen a valid key (the
// correction factor exp(-1e30 - m) underflows to 0, as on the TPU), so the
// result is the same, and a 512-window layer at S = 2048 does about a
// quarter of a global layer's work.  K/V head h / (H / KV) serves query
// head h, so MQA/GQA K/V is read without being expanded.  Inputs may be
// strided views; the head dimension must be contiguous.  Built without
// --use_fast_math: expf and tanhf are the accurate versions.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 32;            // key rows per tile
constexpr int kThreads = 256;
constexpr int kPs = kBK + 1;       // row stride of the probability tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Padded shared-memory row stride in elements: an odd number of 32-bit
// words.  Must agree with smem_stride in kernels/flash_attention.py.
__host__ __device__ inline int smem_stride(int hd, int elem_bytes) {
  if (elem_bytes == 4) return (hd % 2 == 0) ? hd + 1 : hd;
  int s = (hd + 1) / 2 * 2;
  return ((s / 2) % 2 == 0) ? s + 2 : s;
}

__host__ __device__ inline size_t smem_bytes(int hd, int elem_bytes) {
  return (size_t)(kBQ + 2 * kBK) * smem_stride(hd, elem_bytes) * elem_bytes +
         (size_t)kBQ * kPs * sizeof(float);
}

// Copy rows [r0, r0 + rows) of a (S, hd) slice with row stride `ss` into
// shared memory (row stride `ld`), zero-filling rows at or past S.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int r0, int rows, int S, int hd,
                                      long long ss, int ld) {
  for (int idx = threadIdx.x; idx < rows * hd; idx += kThreads) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const int row = r0 + r;
    dst[r * ld + d] = row < S ? src[(long long)row * ss + d] : zero<T>();
  }
}

// NC: head columns per thread, ceil(hd / 16) rounded up to an instance.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, float* __restrict__ out,
                       int H, int group, int S, int hd, long long q_sb,
                       long long q_sh, long long q_ss, long long k_sb,
                       long long k_sh, long long k_ss, long long v_sb,
                       long long v_sh, long long v_ss, float scale,
                       int causal, int window, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = smem_stride(hd, sizeof(T));
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + kBQ * ld;
  T* v_s = k_s + kBK * ld;
  // (kBQ + 2 kBK) * ld elements: a multiple of 4 bytes for both dtypes
  float* p_s = reinterpret_cast<float*>(v_s + kBK * ld);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  stage(q_s, qb, q0, kBQ, S, hd, q_ss, ld);

  // Key range that can hold a valid key for some row of this tile.
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const long long lo = (long long)q0 - window + 1;
  const int k_begin = lo > 0 ? (int)lo : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = k_begin / kBK * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    stage(k_s, kb, k0, kBK, S, hd, k_ss, ld);
    stage(v_s, vb, k0, kBK, S, hd, v_ss, ld);
    __syncthreads();

    // logits for rows 4ty + i, key columns tx and tx + 16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
    const T* qr = q_s + 4 * ty * ld;
    const T* kr0 = k_s + tx * ld;
    const T* kr1 = k_s + (tx + 16) * ld;
    for (int d = 0; d < hd; ++d) {
      const float ka = to_f32(kr0[d]);
      const float kc = to_f32(kr1[d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = to_f32(qr[i * ld + d]);
        s[i][0] += qv * ka;
        s[i][1] += qv * kc;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        const int dd = row - col;
        const bool ok = col < S && (!causal || dd >= 0) && dd < window;
        s[i][j] = ok ? x : kNegInf;
      }
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      const float corr = expf(m[i] - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
      p_s[(4 * ty + i) * kPs + tx] = p0;
      p_s[(4 * ty + i) * kPs + tx + 16] = p1;
    }
    __syncthreads();

    // acc[i][j] += sum_c p[4ty + i][c] * v[c][tx + 16j]
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(4 * ty + i) * kPs + c];
      const T* vr = v_s + c * ld;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < hd ? to_f32(vr[d]) : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }

  float* ob = out + (long long)bh * S * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[(long long)row * hd + d] = acc[i][j] / denom;
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int KV, int S, int hd, long long q_sb,
                   long long q_sh, long long q_ss, long long k_sb,
                   long long k_sh, long long k_ss, long long v_sb,
                   long long v_sh, long long v_ss, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out), H, H / KV, S, hd,
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal,
      window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int KV, int S, int hd, long long q_sb,
                     long long q_sh, long long q_ss, long long k_sb,
                     long long k_sh, long long k_ss, long long v_sb,
                     long long v_sh, long long v_ss, float scale, int causal,
                     int window, float softcap, cudaStream_t stream) {
#define FLASH_LAUNCH(NC)                                                     \
  return launch<T, NC>(q, k, v, out, B, H, KV, S, hd, q_sb, q_sh, q_ss, k_sb, \
                       k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal, window,   \
                       softcap, stream)
  const int nc = (hd + 15) / 16;
  if (nc <= 1) FLASH_LAUNCH(1);
  if (nc <= 2) FLASH_LAUNCH(2);
  if (nc <= 4) FLASH_LAUNCH(4);
  if (nc <= 8) FLASH_LAUNCH(8);
  if (nc <= 18) FLASH_LAUNCH(18);
  if (nc <= 32) FLASH_LAUNCH(32);
#undef FLASH_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements, for the batch,
// head and sequence axes of q, k and v (the head dimension is contiguous).
// Returns the launch's CUDA error (0 on success); allocates nothing.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int H, int KV, int S, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    int window, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || hd <= 0 ||
      window < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, H, KV, S, hd, q_sb, q_sh, q_ss,
                           k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal,
                           window, softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, H, KV, S, hd, q_sb, q_sh,
                                   q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                                   scale, causal, window, softcap, st);
  return cudaErrorInvalidValue;
}
