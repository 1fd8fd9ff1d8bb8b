// Flash attention (online softmax, O(S) memory) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`): for each
// (batch, head) and query row, softmax over the keys of
// s = (q . k) * scale, tanh-softcapped before masking, with the masks
// causal (q - k >= 0), window (q - k < window) and padded keys (k < S);
// masked logits are -1e30 (not -inf), the denominator is clamped at 1e-30
// and the output is float32.  K/V head h / (H / KV) serves query head h,
// so MQA/GQA K/V is read without being expanded.  Inputs may be strided
// views; the head dimension must be contiguous.  Built without
// --use_fast_math: expf and tanhf are the accurate versions.
//
// Two instances of that function, chosen by dtype and head width in one
// place (`flash_attention_instance`, mirrored by `uses_tensor_cores` in
// kernels/flash_attention.py), never on a failure:
//
// * the tensor-core instance (`flash_tc_kernel`): bfloat16 inputs with
//   hd <= kTcMaxHeadDim (every registered arch: 64, 128, 288);
// * the CUDA-core instance (`flash_attention_kernel`): float32 inputs, and
//   bfloat16 wider than the tensor-core instance's register plan.
//
// What bounds it on the H100: at the serving path's shapes (gemma3-1b
// prefill, B = 4, H = 4, S = 2048, hd = 288) the work is 4 * hd FLOP per
// unmasked (q, k) pair, about 39 GFLOP for a global layer: at the
// 989 TFLOP/s bf16 tensor-core rate that is 0.04 ms, above the time to
// move q, k, v and the f32 output once.  So it is bound by operations.
//
// Tensor-core instance.  Q.K^T runs as mma.sync m16n8k16 bf16 -> f32 fed by
// ldmatrix: a product of two bf16 values is exact in f32, so the logits
// keep the TPU kernel's f32 accuracy (it upcasts before its dot).  P.V
// splits each f32 probability into hi = bf16(p) and lo = bf16(p - hi) and
// runs two mma into one f32 accumulator: V is exact in bf16 and hi + lo is
// p to ~2^-16, where a single bf16 term (~2^-9) would miss the 2e-4 check
// against the f32 plain version.  A block is 4 warps over a 64-row query
// tile, each warp owning 16 rows; it walks 32-row key tiles.  The online
// softmax runs on the mma accumulator fragments in registers (row max and
// sum over the 4 threads of a quad by shuffles; no P tile in shared
// memory): the S fragment of two 8-key column tiles is the A fragment of
// one 16-key step of P.V.  A warp holds a 16 x hd f32 output accumulator
// (144 registers a thread at hd = 288) and a 16 x 32 S tile (16): with
// 64-key tiles (32 for S) ptxas spilled at hd = 288, with 32-key tiles it
// fits in 255 registers with no spills.  The O rescale is skipped when no
// row's maximum moved (the factor is exactly 1).  Q, K and V tiles live in
// shared memory in bf16 with rows padded to an odd number of 16-byte
// chunks (hd 288 -> 296 elements), so the 8 rows of one ldmatrix phase fall
// in 8 distinct bank groups; Q, one K and one V tile at hd = 288 take
// 75.8 KB, and two blocks (8 warps, by registers) share an SM.  Tiles are
// staged by 16-byte cp.async (zero-filled past S and past hd) in a
// two-buffer ring where K and V alternate: V_j loads while Q.K_j^T runs,
// K_{j+1} while P.V_j runs.  Key tiles wholly outside the causal band or
// the window are skipped by the CUDA-core instance's rule, and the grid
// walks query tiles from the last (heaviest under the causal mask) to the
// first, so the causal tail is short.  Inputs whose rows are not 16-byte
// aligned are staged element by element instead.
//
// CUDA-core instance.  All arithmetic is float32, on inputs in float32 or
// bfloat16 (upcast on read from shared memory); bound by the float32 issue
// rate (67 TFLOP/s peak, less since every product needs shared-memory
// reads).  One block of 256 threads per (b * h, 64-row query tile).  The
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
// quarter of a global layer's work.

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

// ---------------------------------------------------------------------------
// Tensor-core instance: bfloat16 inputs, hd <= kTcMaxHeadDim
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 64;             // query rows per block (4 warps x 16)
constexpr int kTcBK = 32;             // key rows per tile
constexpr int kTcThreads = 128;
constexpr int kTcMaxHeadDim = 288;    // widest hd of the register plan

using bf16 = __nv_bfloat16;

// 16-column steps of the instance that serves head width hd (its padded
// width is 16 * steps).  Must agree with tc_steps in
// kernels/flash_attention.py.
__host__ __device__ inline int tc_steps(int hd) {
  const int ks = (hd + 15) / 16;
  return ks <= 2 ? 2 : ks <= 4 ? 4 : ks <= 8 ? 8 : ks <= 16 ? 16 : 18;
}

// Shared-memory row stride in elements: the padded width in 16-byte chunks
// (two per step), plus one so the count is odd.
__host__ __device__ inline int tc_smem_stride(int hd) {
  return (2 * tc_steps(hd) + 1) * 8;
}

// Q, K and V tiles in bf16.
__host__ __device__ inline size_t tc_smem_bytes(int hd) {
  return (size_t)(kTcBQ + 2 * kTcBK) * tc_smem_stride(hd) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; bytes past `src_bytes` (0 or 16) are zero.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), packed low element first
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Stage rows [r0, r0 + ROWS) of a (S, hd) bf16 slice with row stride `ss`
// into shared memory (row stride LD), zero past S and past hd up to the
// padded width 8 * CH.  VEC: rows are 16-byte aligned and hd % 8 == 0, so
// each 16-byte chunk is one cp.async; otherwise element by element.
template <int ROWS, int CH, int LD, bool VEC>
__device__ __forceinline__ void tc_stage(bf16* dst, const bf16* __restrict__ src,
                                         int r0, int S, int hd, long long ss) {
  if (VEC) {
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += kTcThreads) {
      const int r = idx / CH;
      const int c = idx - r * CH;
      const int row = r0 + r;
      const bool in = row < S && c * 8 < hd;
      cp_async16(smem_u32(dst + r * LD + c * 8),
                 in ? src + (long long)row * ss + c * 8 : src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * CH * 8; idx += kTcThreads) {
      const int r = idx / (CH * 8);
      const int d = idx - r * CH * 8;
      const int row = r0 + r;
      dst[r * LD + d] = row < S && d < hd ? src[(long long)row * ss + d]
                                          : __float2bfloat16(0.0f);
    }
  }
}

// KS: 16-column steps of the padded head width (tc_steps); VEC: staged by
// cp.async (see tc_stage).
template <int KS, bool VEC>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, float* __restrict__ out, int H,
                int group, int S, int hd, long long q_sb, long long q_sh,
                long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss, float scale,
                int causal, int window, float softcap) {
  constexpr int CH = 2 * KS;         // 16-byte chunks of a padded row
  constexpr int LD = (CH + 1) * 8;   // tc_smem_stride
  constexpr int NT = 2 * KS;         // 8-column tiles of the output
  constexpr int SN = kTcBK / 8;      // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTcBQ * LD;
  bf16* v_s = k_s + kTcBK * LD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;           // fragment row (and row + 8)
  const int t = lane & 3;            // fragment column pair
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;  // heaviest first
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;

  // Key range that can hold a valid key for some row of this tile.
  const int q_last = min(q0 + kTcBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const long long lo = (long long)q0 - window + 1;
  const int k_begin = lo > 0 ? (int)lo : 0;
  const int t0 = k_begin / kTcBK * kTcBK;

  tc_stage<kTcBQ, CH, LD, VEC>(q_s, qb, q0, S, hd, q_ss);
  tc_stage<kTcBK, CH, LD, VEC>(k_s, kb, t0, S, hd, k_ss);
  cp_async_commit();

  // ldmatrix row addresses of this lane: Q as the A operand (rows, then
  // the column half), K as B (key rows of two 8-key tiles, column half),
  // V as B transposed (key rows, then two 8-column tiles).
  const uint32_t q_addr = smem_u32(
      q_s + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
      8 * (lane >> 4));
  const uint32_t k_addr =
      smem_u32(k_s + ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1));
  const uint32_t v_addr =
      smem_u32(v_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4));

  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0 + 8
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};             // this thread's share of the sum

  for (int k0 = t0; k0 < k_end; k0 += kTcBK) {
    cp_async_wait_all();
    __syncthreads();       // K_j (and Q) landed; every warp is done with V
    tc_stage<kTcBK, CH, LD, VEC>(v_s, vb, k0, S, hd, v_ss);
    cp_async_commit();

    // S = Q . K^T over KS steps of 16 head columns
    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, q_addr + ks * 32);
#pragma unroll
      for (int n = 0; n < SN; n += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, k_addr + (n * 8 * LD + ks * 16) * 2);
        mma_bf16(s[n], a, bk[0], bk[1]);
        mma_bf16(s[n + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap, mask; online softmax on the fragments
    const bool full = k0 + kTcBK <= S && (!causal || k0 + kTcBK - 1 <= q0) &&
                      q_last - k0 < window;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        if (!full) {
          const int row = row0 + 8 * (e >> 1);
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          const int dd = row - col;
          const bool ok = col < S && (!causal || dd >= 0) && dd < window;
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < SN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
    // once the row maxima settle, corr is exactly 1 for the whole warp
    if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }

    cp_async_wait_all();
    __syncthreads();       // V_j landed; every warp is done with K_j
    if (k0 + kTcBK < k_end) {
      tc_stage<kTcBK, CH, LD, VEC>(k_s, kb, k0 + kTcBK, S, hd, k_ss);
      cp_async_commit();
    }

    // O += (P_hi + P_lo) . V, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, v_addr + (kk * 16 * LD + n * 8) * 2);
        mma_bf16(o[n], ph, bv[0], bv[1]);
        mma_bf16(o[n], pl, bv[0], bv[1]);
        mma_bf16(o[n + 1], ph, bv[2], bv[3]);
        mma_bf16(o[n + 1], pl, bv[2], bv[3]);
      }
    }
  }

  float* ob = out + (long long)bh * S * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = ob + (long long)row * hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = 8 * n + 2 * t;
      const float x0 = o[n][2 * r] / denom;
      const float x1 = o[n][2 * r + 1] / denom;
      if (d + 1 < hd && (hd & 1) == 0) {
        *reinterpret_cast<float2*>(orow + d) = make_float2(x0, x1);
      } else {
        if (d < hd) orow[d] = x0;
        if (d + 1 < hd) orow[d + 1] = x1;
      }
    }
  }
}

template <int KS, bool VEC>
cudaError_t tc_launch(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int KV, int S, int hd, long long q_sb,
                      long long q_sh, long long q_ss, long long k_sb,
                      long long k_sh, long long k_ss, long long v_sb,
                      long long v_sh, long long v_ss, float scale, int causal,
                      int window, float softcap, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<KS, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kTcBQ - 1) / kTcBQ);
  flash_tc_kernel<KS, VEC><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(out), H, H / KV, S, hd,
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal,
      window, softcap);
  return cudaGetLastError();
}

cudaError_t tc_dispatch(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int KV, int S, int hd,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        float scale, int causal, int window, float softcap,
                        cudaStream_t stream) {
  // cp.async needs 16-byte aligned rows: base pointers and every stride
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = hd % 8 == 0 && al(q) && al(k) && al(v) &&
                   (q_sb | q_sh | q_ss | k_sb | k_sh | k_ss | v_sb | v_sh |
                    v_ss) % 8 == 0;
#define FLASH_TC_LAUNCH(KS)                                                   \
  return vec ? tc_launch<KS, true>(q, k, v, out, B, H, KV, S, hd, q_sb, q_sh, \
                                   q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,  \
                                   scale, causal, window, softcap, stream)    \
             : tc_launch<KS, false>(q, k, v, out, B, H, KV, S, hd, q_sb,      \
                                    q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, \
                                    v_ss, scale, causal, window, softcap,     \
                                    stream)
  switch (tc_steps(hd)) {
    case 2: FLASH_TC_LAUNCH(2);
    case 4: FLASH_TC_LAUNCH(4);
    case 8: FLASH_TC_LAUNCH(8);
    case 16: FLASH_TC_LAUNCH(16);
    case 18: FLASH_TC_LAUNCH(18);
  }
#undef FLASH_TC_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Which instance serves (dtype, hd): 1 the tensor-core instance, 0 the
// CUDA-core instance, -1 none.  The one place the rule lives; mirrored by
// uses_tensor_cores in kernels/flash_attention.py.
extern "C" int flash_attention_instance(int dtype, int hd) {
  if (hd <= 0 || (dtype != 0 && dtype != 1)) return -1;
  return dtype == 1 && hd <= kTcMaxHeadDim ? 1 : 0;
}

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
  const int instance = flash_attention_instance(dtype, hd);
  if (instance == 1)
    return tc_dispatch(q, k, v, out, B, H, KV, S, hd, q_sb, q_sh, q_ss, k_sb,
                       k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal, window,
                       softcap, st);
  if (instance != 0) return cudaErrorInvalidValue;
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
