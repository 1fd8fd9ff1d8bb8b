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
// Four instances of that function, chosen by dtype and head width in one
// place (`flash_attention_instance`, mirrored by `instance` in
// kernels/flash_attention.py), never on a failure:
//
// * the wgmma instance (`flash_wg_kernel`): bfloat16 inputs with
//   hd <= kWgMaxHeadDim (128; granite-moe's, whisper's and qwen3-moe's 64);
// * the tensor-core instance (`flash_tc_kernel`): bfloat16 inputs with
//   kWgMaxHeadDim < hd <= kTcMaxHeadDim (recurrentgemma's 256, gemma3's 288);
// * the f32 tensor-core instance (`flash_tc32_kernel`): float32 inputs with
//   hd <= kTc32MaxHeadDim (256; the kernel bench's hd 128);
// * the CUDA-core instance (`flash_attention_kernel`): float32 and bfloat16
//   wider than the tensor-core instances' register plans.
//
// What bounds it on the H100: at the serving path's shapes (gemma3-1b
// prefill, B = 4, H = 4, S = 2048, hd = 288) the work is 4 * hd FLOP per
// unmasked (q, k) pair, about 39 GFLOP for a global layer: at the
// 989 TFLOP/s bf16 tensor-core rate that is 0.04 ms, above the time to
// move q, k, v and the f32 output once.  So it is bound by operations.
// In f32 (the kernel bench, B = 1, H = 8, S = 4096, hd = 128, causal) one
// pass at the 494.7 TFLOP/s TF32 rate takes 69.5 us, above the 20.0 us of
// bytes; the f32 tensor-core instance's split arithmetic below is 2.25x
// that one pass.
//
// Tensor-core instance (bf16, hd 129-288).  Q.K^T runs as mma.sync
// m16n8k16 bf16 -> f32 fed by ldmatrix: a product of two bf16 values is
// exact in f32, so the logits keep the TPU kernel's f32 accuracy (it
// upcasts before its dot).  P.V
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
// wgmma instance.  The tensor-core instance's arithmetic (exact bf16
// products summed in f32 for Q.K^T, P_hi.V + P_lo.V into one f32
// accumulator) on Hopper's warpgroup MMA, the only way to the card's full
// bf16 rate.  At granite-moe's prefill (B 4, H 24, KV 8, S 2,048, hd 64,
// causal) one pass is 52 us at 989 TFLOP/s, 78 us with the split P.V, and
// the softmax's 2.0e8 exponentials take the special function units 48 us
// (16 a clock an SM at 1.98 GHz): it is bound by operations on both.
//
// A block is two consumer warpgroups and a producer warpgroup, one block
// an SM, persistent: it walks work items heaviest first (`wg_item`).  An
// item's 128 query rows pack the `group` query heads of one KV head by
// position (row pr is position pr / group of head pr % group), so each
// staged K/V tile serves every head that reads it (granite: 3) and MQA/GQA
// needs no second pass over K and V; a consumer owns 64 of the rows.  S =
// Q.K^T is wgmma m64n128k16 with Q and a 128-key K tile read from shared
// memory through descriptors (both K-major, hd contiguous); P.V is
// m64nNPk16 (NP the padded head width, 64 or 128) with P in registers,
// since the S accumulator's layout is the register A layout of 16-bit
// wgmma, and V read MN-major (the transpose bit).  Tiles are stored in the
// 128-byte swizzle the descriptors read (`wg_swizzle`): 64-column blocks
// of 128-byte rows, 16-byte chunk c of row r at c ^ (r % 8), 1,024-byte
// aligned.
//
// The producer stages each item's Q into one of two buffers and its K/V
// tiles into a ring of stages (three at NP 64, two at 128) with cp.async,
// or element by element where rows are not 16-byte aligned; every buffer
// has a full mbarrier (the producer's copies landed) and an empty one (the
// consumers are done), so a consumer waits only for the tile it needs and
// the next item's Q and first tiles load while the current item finishes.
// The producer gives registers to the consumers (setmaxnreg).  Each
// consumer runs a software pipeline: S_i = Q.K_i^T is issued together with
// O += P_{i-1}.V_{i-1}, the softmax of S_i runs while the latter is on the
// tensor cores, and every wait on a product is unconditional (a wait
// under a condition makes ptxas serialize every wgmma of the kernel).  The
// two consumers take turns to issue their products (named barriers), so
// one's softmax overlaps the other's products.  The softmax works in base
// 2 on the accumulator fragments: maximum over the raw products, the scale
// times log2 e folded into the FMA before ex2.approx, masked products -inf
// (see wg_mask), row max and sum over the quad by shuffles, the rescale of
// O skipped when no row maximum moved.  P_hi is p truncated to bf16, which
// one byte permute packs for two values.  Heaviest-first order and the
// skip of key tiles outside the causal band or the window (by the item's
// first and last positions) are the other instances'.  Two Q buffers (32
// KB at hd 64), three K/V stages (96 KB) and the barriers take 129 KB.
//
// f32 tensor-core instance.  A single TF32 pass (10-bit mantissas) misses
// the 2e-4 check against the f32 plain version, and three bf16 products
// for Q.K^T miss it at logits of ~9 (input scale 3, softcap 50), so each
// product is split.  Q.K^T runs as mma.sync m16n8k8 tf32 -> f32 on
// hi = tf32(x), lo = tf32(x - hi) (cvt.rna): hi.hi + hi.lo + lo.hi in one
// f32 accumulator, lo.lo dropped (~2^-22 relative).  Q and K stay f32 in
// shared memory, and ldmatrix loads their fragments as is: an 8 x 8 b16
// matrix is 8 rows of 4 f32, lane l getting (row l / 4, column l % 4), the
// tf32 A layout for row-major Q and the B layout for K stored by key; the
// split is done in registers at each load (Q's fragments are not held
// across key tiles: at hd 128 they alone would take 128 registers).  A
// warp holds the same 16 x hd f32 output accumulator as the tensor-core
// instance, and the split operands add about a dozen registers: at hd 288
// (144 accumulator registers) the cp.async instance spilled at 255 under
// every unroll and ldmatrix width tried, so the plan stops at hd 256, whose
// instance fits in 255 with no spills.  The
// m16n8k8 accumulator has the m16n8k16 layout, so the online softmax is
// the tensor-core instance's (`tc_softmax`).  P.V runs as m16n8k16 bf16
// with P and V each split in two bf16 terms: p_hi.v_hi + p_hi.v_lo +
// p_lo.v_hi (~2^-16 relative).  V is staged as an f32 tile by cp.async and
// split once per block into bf16 hi and lo planes in shared memory, which
// ldmatrix.trans reads as in the tensor-core instance: holding V's next
// tile in registers instead would take 64 registers a thread at hd 256,
// beside a 128-register accumulator, and splitting in each warp would do
// it four times.  f32 rows are padded to an odd number of 16-byte chunks
// (hd 256 -> 260 floats).  Q, K and V's f32 tile and the two planes take
// 166.9 KB at hd 256 (one block an SM) and 85.0 KB at hd 128 (two).  A key
// tile j: wait for K_j and V_j, split V_j, then load V_{j+1} while Q.K_j^T
// and the softmax run, and K_{j+1} while P.V_j runs.  Tile skipping,
// masking, the skipped rescale and the heaviest-first order are the
// tensor-core instance's.  Costed in bf16 m16n8k16 units per 16 head
// columns of a (q, k) pair, Q.K^T is 6 and P.V 3: 3x the tensor-core
// instance.
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
#include <type_traits>
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

// Stage rows [r0, r0 + ROWS) of a (S, hd) slice with row stride `ss` into
// shared memory (row stride LD), zero past S and past hd up to the padded
// width of CH 16-byte chunks.  VEC: rows are 16-byte aligned and hd is a
// whole number of chunks, so each chunk is one cp.async; otherwise element
// by element.
template <int ROWS, int CH, int LD, bool VEC, typename T>
__device__ __forceinline__ void tc_stage(T* dst, const T* __restrict__ src,
                                         int r0, int S, int hd, long long ss) {
  constexpr int E = 16 / sizeof(T);  // elements of a chunk
  if (VEC) {
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += kTcThreads) {
      const int r = idx / CH;
      const int c = idx - r * CH;
      const int row = r0 + r;
      const bool in = row < S && c * E < hd;
      cp_async16(smem_u32(dst + r * LD + c * E),
                 in ? src + (long long)row * ss + c * E : src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * CH * E; idx += kTcThreads) {
      const int r = idx / (CH * E);
      const int d = idx - r * CH * E;
      const int row = r0 + r;
      dst[r * LD + d] = row < S && d < hd ? src[(long long)row * ss + d]
                                          : zero<T>();
    }
  }
}

// Scale, softcap and mask one 16 x kTcBK tile of logits held in mma
// accumulator fragments (this thread's rows row0 and row0 + 8, columns
// k0 + 8n + 2t and the next), then one step of the online softmax: s
// becomes the probabilities, m and l (this thread's share of the row sums)
// move on, and o is rescaled where a row's maximum moved.  `full`: no
// logit of the tile is masked.  The f32 tensor-core instance's: the
// tensor-core instance keeps the same steps inline, since calling these
// changed ptxas's register allocation of its instances (more spills in
// those staged element by element).
template <int NT>
__device__ __forceinline__ void tc_softmax(float (&s)[kTcBK / 8][4],
                                           float (&o)[NT][4], float (&m)[2],
                                           float (&l)[2], bool full, int row0,
                                           int k0, int t, int S, int causal,
                                           int window, float scale,
                                           float softcap) {
  constexpr int SN = kTcBK / 8;
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
}

// Sum l over the quad, then write this thread's share of rows row0 and
// row0 + 8 of O / l (the (S, hd) slice at ob).
template <int NT>
__device__ __forceinline__ void tc_store(float* ob, const float (&o)[NT][4],
                                         float (&l)[2], int row0, int t,
                                         int S, int hd) {
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

// ---------------------------------------------------------------------------
// f32 tensor-core instance: float32 inputs, hd <= kTc32MaxHeadDim
// ---------------------------------------------------------------------------

constexpr int kTc32MaxHeadDim = 256;  // widest hd of the register plan

// f32 shared-memory row stride in floats: the padded width 16 * tc_steps
// in 16-byte chunks (four per step), plus one so the count is odd.  Must
// agree with tc32_smem_stride in kernels/flash_attention.py.
__host__ __device__ inline int tc32_smem_stride(int hd) {
  return (4 * tc_steps(hd) + 1) * 4;
}

// Q, K and V tiles in f32, and V's bf16 hi and lo planes.
__host__ __device__ inline size_t tc32_smem_bytes(int hd) {
  return (size_t)(kTcBQ + 2 * kTcBK) * tc32_smem_stride(hd) * sizeof(float) +
         (size_t)2 * kTcBK * tc_smem_stride(hd) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// f32 bits x -> hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  const float f = __uint_as_float(x);
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}

// c += a (16 x 8, row) . b (8 x 8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Split a staged f32 V tile (row stride LDF, CH 16-byte chunks a row) into
// bf16 hi = bf16(v) and lo = bf16(v - hi) planes (row stride LD).
template <int CH, int LDF, int LD>
__device__ __forceinline__ void tc32_split_v(const float* vf, bf16* vh,
                                             bf16* vl) {
  for (int idx = threadIdx.x; idx < kTcBK * CH; idx += kTcThreads) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    const float4 x = *reinterpret_cast<const float4*>(vf + r * LDF + 4 * c);
    uint2 hi, lo;
    split_bf16(x.x, x.y, hi.x, lo.x);
    split_bf16(x.z, x.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(vh + r * LD + 4 * c) = hi;
    *reinterpret_cast<uint2*>(vl + r * LD + 4 * c) = lo;
  }
}

// KS: 16-column steps of the padded head width (tc_steps); VEC: staged by
// cp.async (see tc_stage).
template <int KS, bool VEC>
__global__ void __launch_bounds__(kTcThreads)
flash_tc32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int H,
                  int group, int S, int hd, long long q_sb, long long q_sh,
                  long long q_ss, long long k_sb, long long k_sh,
                  long long k_ss, long long v_sb, long long v_sh,
                  long long v_ss, float scale, int causal, int window,
                  float softcap) {
  constexpr int CH = 4 * KS;          // 16-byte chunks of a padded f32 row
  constexpr int LDF = (CH + 1) * 4;   // tc32_smem_stride
  constexpr int LD = (2 * KS + 1) * 8;  // tc_smem_stride: V's bf16 planes
  constexpr int NT = 2 * KS;          // 8-column tiles of the output
  constexpr int SN = kTcBK / 8;       // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + kTcBQ * LDF;
  float* vf_s = k_s + kTcBK * LDF;
  bf16* vh_s = reinterpret_cast<bf16*>(vf_s + kTcBK * LDF);
  bf16* vl_s = vh_s + kTcBK * LD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;            // fragment row (and row + 8)
  const int t = lane & 3;             // fragment column (pair)
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;  // heaviest first
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh;

  // Key range that can hold a valid key for some row of this tile.
  const int q_last = min(q0 + kTcBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const long long lo = (long long)q0 - window + 1;
  const int k_begin = lo > 0 ? (int)lo : 0;
  const int t0 = k_begin / kTcBK * kTcBK;

  tc_stage<kTcBQ, CH, LDF, VEC>(q_s, qb, q0, S, hd, q_ss);
  tc_stage<kTcBK, CH, LDF, VEC>(k_s, kb, t0, S, hd, k_ss);
  tc_stage<kTcBK, CH, LDF, VEC>(vf_s, vb, t0, S, hd, v_ss);
  cp_async_commit();

  // ldmatrix row addresses of this lane, as in the tensor-core instance
  // with 16-byte chunks of 4 floats: Q as the tf32 A operand (rows, then
  // the chunk of columns 4..7), K as B (key rows of two 8-key tiles, then
  // the chunk), V's planes as B transposed.
  const uint32_t q_addr = smem_u32(
      q_s + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDF +
      4 * (lane >> 4));
  const uint32_t k_addr = smem_u32(
      k_s + ((lane & 7) + 8 * (lane >> 4)) * LDF + 4 * ((lane >> 3) & 1));
  const uint32_t vh_addr = smem_u32(
      vh_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4));
  const uint32_t vl_addr = vh_addr + kTcBK * LD * sizeof(bf16);

  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0 + 8
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};             // this thread's share of the sum

  for (int k0 = t0; k0 < k_end; k0 += kTcBK) {
    const bool more = k0 + kTcBK < k_end;
    cp_async_wait_all();
    __syncthreads();       // K_j and V_j landed; every warp is done with P.V
    tc32_split_v<CH, LDF, LD>(vf_s, vh_s, vl_s);
    __syncthreads();       // V_j's planes are written, its f32 tile is free
    if (more) {
      tc_stage<kTcBK, CH, LDF, VEC>(vf_s, vb, k0 + kTcBK, S, hd, v_ss);
      cp_async_commit();
    }

    // S = Q . K^T over 2 KS steps of 8 head columns, each product split:
    // lo.hi + hi.lo + hi.hi
    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 2 * KS; ++ks) {
      uint32_t qf[4], qh[4], ql[4];
      ldsm_x4(qf, q_addr + ks * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(qf[i], qh[i], ql[i]);
#pragma unroll
      for (int n = 0; n < SN; n += 2) {
        uint32_t kf[4], kh[4], kl[4];
        ldsm_x4(kf, k_addr + (n * 8 * LDF + ks * 8) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(kf[i], kh[i], kl[i]);
        mma_tf32(s[n], ql, kh[0], kh[1]);
        mma_tf32(s[n], qh, kl[0], kl[1]);
        mma_tf32(s[n], qh, kh[0], kh[1]);
        mma_tf32(s[n + 1], ql, kh[2], kh[3]);
        mma_tf32(s[n + 1], qh, kl[2], kl[3]);
        mma_tf32(s[n + 1], qh, kh[2], kh[3]);
      }
    }

    const bool full = k0 + kTcBK <= S && (!causal || k0 + kTcBK - 1 <= q0) &&
                      q_last - k0 < window;
    tc_softmax(s, o, m, l, full, row0, k0, t, S, causal, window, scale,
               softcap);

    __syncthreads();       // every warp is done with K_j
    if (more) {
      tc_stage<kTcBK, CH, LDF, VEC>(k_s, kb, k0 + kTcBK, S, hd, k_ss);
      cp_async_commit();
    }

    // O += P . V with P and V each split in two bf16 terms, 16 keys a
    // step: lo.hi + hi.lo + hi.hi
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t vh[4], vl[4];
        const uint32_t off = (kk * 16 * LD + n * 8) * sizeof(bf16);
        ldsm_x4_t(vh, vh_addr + off);
        ldsm_x4_t(vl, vl_addr + off);
        mma_bf16(o[n], pl, vh[0], vh[1]);
        mma_bf16(o[n], ph, vl[0], vl[1]);
        mma_bf16(o[n], ph, vh[0], vh[1]);
        mma_bf16(o[n + 1], pl, vh[2], vh[3]);
        mma_bf16(o[n + 1], ph, vl[2], vl[3]);
        mma_bf16(o[n + 1], ph, vh[2], vh[3]);
      }
    }
  }

  tc_store(out + (long long)bh * S * hd, o, l, row0, t, S, hd);
}

// The tensor-core kernel of an element type: bf16 or f32.
template <int KS, bool VEC>
inline auto tc_kernel(const bf16*) { return flash_tc_kernel<KS, VEC>; }
template <int KS, bool VEC>
inline auto tc_kernel(const float*) { return flash_tc32_kernel<KS, VEC>; }

template <typename T, int KS, bool VEC>
cudaError_t tc_launch(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int KV, int S, int hd, long long q_sb,
                      long long q_sh, long long q_ss, long long k_sb,
                      long long k_sh, long long k_ss, long long v_sb,
                      long long v_sh, long long v_ss, float scale, int causal,
                      int window, float softcap, cudaStream_t stream) {
  auto kernel = tc_kernel<KS, VEC>(static_cast<const T*>(nullptr));
  const size_t smem = std::is_same<T, float>::value ? tc32_smem_bytes(hd)
                                                    : tc_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kTcBQ - 1) / kTcBQ);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out), H, H / KV, S, hd,
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal,
      window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t tc_dispatch(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int KV, int S, int hd,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        float scale, int causal, int window, float softcap,
                        cudaStream_t stream) {
  // cp.async needs 16-byte aligned rows: base pointers and every stride
  constexpr long long E = 16 / sizeof(T);
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = hd % E == 0 && al(q) && al(k) && al(v) &&
                   (q_sb | q_sh | q_ss | k_sb | k_sh | k_ss | v_sb | v_sh |
                    v_ss) % E == 0;
#define FLASH_TC_LAUNCH(KS)                                                   \
  return vec ? tc_launch<T, KS, true>(q, k, v, out, B, H, KV, S, hd, q_sb,    \
                                      q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,     \
                                      v_sh, v_ss, scale, causal, window,      \
                                      softcap, stream)                        \
             : tc_launch<T, KS, false>(q, k, v, out, B, H, KV, S, hd, q_sb,   \
                                       q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,    \
                                       v_sh, v_ss, scale, causal, window,     \
                                       softcap, stream)
  // bf16 below hd 129 goes to the wgmma instance, so only its 16- and
  // 18-step instances are built; f32 stops at 16 (kTc32MaxHeadDim)
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (tc_steps(hd)) {
    case 2:
      if constexpr (f32) FLASH_TC_LAUNCH(2);
      break;
    case 4:
      if constexpr (f32) FLASH_TC_LAUNCH(4);
      break;
    case 8:
      if constexpr (f32) FLASH_TC_LAUNCH(8);
      break;
    case 16: FLASH_TC_LAUNCH(16);
    case 18:
      if constexpr (!f32) FLASH_TC_LAUNCH(18);
  }
#undef FLASH_TC_LAUNCH
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma instance: bfloat16 inputs, hd <= kWgMaxHeadDim
// ---------------------------------------------------------------------------

constexpr int kWgMaxHeadDim = 128;  // widest hd of the instance
constexpr int kWgBM = 64;           // packed query rows of a consumer warpgroup
constexpr int kWgConsumers = 2;     // consumer warpgroups a block
constexpr int kWgRows = kWgBM * kWgConsumers;  // packed query rows a block
constexpr int kWgBN = 128;          // keys a tile
constexpr int kWgThreads = 128 * (kWgConsumers + 1);  // and a producer
constexpr int kWgProducerRegs = 40;   // setmaxnreg: the producer gives up
constexpr int kWgConsumerRegs = 232;  // registers the consumers take
constexpr float kLog2e = 1.4426950408889634f;

// Padded head width of the instance serving hd (whole 128-byte swizzle
// rows, 64 or 128 columns) and the K/V stages of its ring at that width
// (as many as shared memory holds beside two Q buffers).  Must agree with
// wg_width and wg_stages in kernels/flash_attention.py.
__host__ __device__ inline int wg_width(int hd) { return hd <= 64 ? 64 : 128; }
__host__ __device__ constexpr int wg_stages(int width) {
  return width == 64 ? 3 : 2;
}

// Dynamic shared memory: 1 KB of slack to align the tiles to the 1,024-byte
// swizzle atom, two buffers of Q tiles, the K/V ring, and a full and an
// empty mbarrier a stage and a Q buffer.
__host__ __device__ inline size_t wg_smem_bytes(int hd) {
  const int w = wg_width(hd);
  return 1024 + (size_t)(2 * kWgRows + 2 * wg_stages(w) * kWgBN) * w * 2 +
         (size_t)2 * (wg_stages(w) + 2) * 8;
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of `rows` rows:
// 64-column blocks of `rows` x 128 bytes, chunk c % 8 of a row stored at
// (c % 8) ^ (r % 8), the 128-byte swizzle that wgmma's descriptors read
// (layout type 1) from a tile aligned to 1,024 bytes.
__host__ __device__ inline uint32_t wg_swizzle(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup's wgmma are
// pending (they complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of a wgmma accumulator
// across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void wg_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}

// Arrive on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete.  A wait that
// lasts ~10 s of SM clock traps, so a fault in the ring's counts shows as a
// launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000ll) __trap();
  }
}

// Named barriers over `n` threads (bar 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 16) . B (16 x 128), A and B
// bf16 in shared memory, both K-major, read through descriptors
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16) . B (16 x 64), A bf16 in registers (the
// mma.sync m16n8k16 A layout, a warp per 16 rows), B bf16 in shared memory,
// MN-major (transposed), read through a descriptor
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16) . B (16 x 128), A bf16 in registers (the
// mma.sync m16n8k16 A layout, a warp per 16 rows), B bf16 in shared memory,
// MN-major (transposed), read through a descriptor
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// Stage keys [k0, k0 + kWgBN) of a (S, hd) K or V slice with row stride ss
// into a swizzled tile at shared address dst (generic pointer dst_g), zero
// past S and past hd: by cp.async (VEC) or element by element, by the 128
// threads of the producer warpgroup.
template <int NP, bool VEC>
__device__ __forceinline__ void wg_stage_kv(uint32_t dst, unsigned char* dst_g,
                                            const bf16* __restrict__ src,
                                            int k0, int S, int hd,
                                            long long ss, int t) {
  constexpr int CH = NP / 8;     // 16-byte chunks a row
  constexpr int RP = 128 / CH;   // rows the warpgroup covers a pass
  if (VEC) {
    // this thread's chunk column, and so its swizzle, is the same in every
    // pass: each copy moves the addresses by RP rows
    const int r = t / CH;
    const int c = t - r * CH;
    const bool col_in = c * 8 < hd;
    const uint32_t d0 = dst + wg_swizzle(r, c, kWgBN);
    const bf16* s0 = src + (long long)(k0 + r) * ss + c * 8;
#pragma unroll
    for (int j = 0; j < kWgBN / RP; ++j) {
      const bool in = col_in && k0 + r + RP * j < S;
      cp_async16(d0 + RP * j * 128, in ? s0 + (long long)RP * j * ss : src,
                 in ? 16 : 0);
    }
  } else {
    for (int idx = t; idx < kWgBN * NP; idx += 128) {
      const int r = idx / NP;
      const int d = idx - r * NP;
      const int row = k0 + r;
      *reinterpret_cast<bf16*>(dst_g + wg_swizzle(r, d >> 3, kWgBN) +
                               (d & 7) * 2) =
          row < S && d < hd ? src[(long long)row * ss + d] : zero<bf16>();
    }
  }
}

// Stage an item's kWgRows packed query rows from row r0 on, each consumer
// warpgroup's 64 as its own swizzled tile: row pr is position pr / group
// of query head hk * group + pr % group (qb points at head hk * group),
// zero at positions past S and past hd.  By the producer warpgroup's 128
// threads; with cp.async each keeps one chunk column.
template <int NP, bool VEC>
__device__ __forceinline__ void wg_stage_q(uint32_t dst, unsigned char* dst_g,
                                           const bf16* __restrict__ qb,
                                           int r0, int group, int S, int hd,
                                           long long q_sh, long long q_ss,
                                           int t) {
  constexpr int CH = NP / 8;
  constexpr int RP = 128 / CH;
  constexpr int QT = kWgBM * NP * 2;
  if (VEC) {
    const int rr = t / CH;
    const int c = t - rr * CH;
#pragma unroll
    for (int j = 0; j < kWgRows / RP; ++j) {
      const int r = rr + RP * j;
      const int pos = (r0 + r) / group;
      const int g = r0 + r - pos * group;
      const bool in = pos < S && c * 8 < hd;
      cp_async16(dst + (r / kWgBM) * QT + wg_swizzle(r % kWgBM, c, kWgBM),
                 in ? qb + (long long)pos * q_ss + g * q_sh + c * 8 : qb,
                 in ? 16 : 0);
    }
  } else {
    for (int idx = t; idx < kWgRows * NP; idx += 128) {
      const int r = idx / NP;
      const int d = idx - r * NP;
      const int pos = (r0 + r) / group;
      const int g = r0 + r - pos * group;
      *reinterpret_cast<bf16*>(dst_g + (r / kWgBM) * QT +
                               wg_swizzle(r % kWgBM, d >> 3, kWgBM) +
                               (d & 7) * 2) =
          pos < S && d < hd ? qb[(long long)pos * q_ss + g * q_sh + d]
                            : zero<bf16>();
    }
  }
}

// S (64 x kWgBN, f32) = Q . K^T over NP / 16 steps of 16 head columns:
// the warpgroup's Q tile (descriptor q_desc) against the K tile at k_t.
template <int NP>
__device__ __forceinline__ void wg_qk(float (&sc)[kWgBN / 2], uint64_t q_desc,
                                      uint32_t k_t) {
  const uint64_t k_desc = wg_desc(k_t, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    wgmma_ss(sc, q_desc + (((kk >> 2) * kWgBM * 128 + col) >> 4),
             k_desc + (((kk >> 2) * kWgBN * 128 + col) >> 4), kk > 0);
  }
}

// O += (P_hi + P_lo) . V, 16 keys a step, V the tile at v_t: the S
// fragments of two 8-key column tiles are the register A fragment of one
// step.
template <int NO>
__device__ __forceinline__ void wg_pv(float (&o)[NO],
                                      const uint32_t (&ph)[kWgBN / 16][4],
                                      const uint32_t (&pl)[kWgBN / 16][4],
                                      uint32_t v_t) {
  const uint64_t v_desc = wg_desc(v_t, kWgBN * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < kWgBN / 16; ++kk) {
    wgmma_rs(o, ph[kk], v_desc + kk * (2048 >> 4));
    wgmma_rs(o, pl[kk], v_desc + kk * (2048 >> 4));
  }
}

// The tanh softcap on this thread's S fragments, in log2 units after it.
template <int NS>
__device__ __forceinline__ void wg_softcap(float (&s)[NS], float scale,
                                           float softcap) {
  const float in = scale / softcap;
  const float out = softcap * kLog2e;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = tanhf(s[i] * in) * out;
}

// The causal, window and padded-key masks on this thread's S fragments
// (rows pos[0] and pos[1], columns k0 + 8n + 2 (lane % 4) and the next):
// -inf where masked.  A finite stand-in such as the reference's -1e30 would
// leave wg_softmax's FMA the rounding error of its own product (~1e22 at
// -1e30 x scale) and overflow ex2; -inf gives the reference's result on
// every row written, since each has a valid key, its own position.
template <int NS>
__device__ __forceinline__ void wg_mask(float (&s)[NS], int k0, int lane,
                                        const int (&pos)[2], int S,
                                        int causal, int window) {
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 8 * n + 2 * (lane & 3) + (e & 1);
      const int dd = pos[e >> 1] - col;
      const bool ok = col < S && (!causal || dd >= 0) && dd < window;
      s[4 * n + e] = ok ? s[4 * n + e] : __uint_as_float(0xff800000u);
    }
  }
}

// One key tile of the online softmax on the S fragments, whose logits in
// log2 units are s * mul (mul: scale * log2 e, or 1 after the softcap):
// s becomes the probabilities, m (log2 units) and l (this thread's share
// of the row sums) move on, and corr is the factor O must be rescaled by.
// The maximum is taken before the multiply (mul > 0), which the exponent's
// FMA then applies.
template <int NS>
__device__ __forceinline__ void wg_softmax(float (&s)[NS], float (&m)[2],
                                           float (&l)[2], float (&corr)[2],
                                           float mul) {
  // four partial maxima and sums a row (element i's row is (i / 2) % 2,
  // its partial i / 4 % 4) keep the dependency chains short
  float mp[2][4], lp[2][4];
#pragma unroll
  for (int i = 0; i < 16; i += 2)
    mp[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(s[i], s[i + 1]);
#pragma unroll
  for (int i = 16; i < NS; ++i)
    mp[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mp[(i >> 1) & 1][(i >> 2) & 3], s[i]);
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * mul);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = ex2(fmaf(s[i], mul, -m[(i >> 1) & 1]));
#pragma unroll
  for (int i = 0; i < 16; i += 2)
    lp[(i >> 1) & 1][(i >> 2) & 3] = s[i] + s[i + 1];
#pragma unroll
  for (int i = 16; i < NS; ++i) lp[(i >> 1) & 1][(i >> 2) & 3] += s[i];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * corr[r] + ((lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]));
}

// P_hi = p truncated to bf16 (its upper 16 bits: one byte permute packs
// two), P_lo = bf16(p - P_hi) (p - P_hi is exact), of this thread's
// probabilities, in the register A layout of wgmma.  P_hi + P_lo is p to
// ~2^-16, as with a rounded P_hi, in fewer instructions.
template <int NS>
__device__ __forceinline__ void wg_split(const float (&s)[NS],
                                         uint32_t (&ph)[kWgBN / 16][4],
                                         uint32_t (&pl)[kWgBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kWgBN / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b0 = __float_as_uint(s[8 * kk + 2 * j]);
      const uint32_t b1 = __float_as_uint(s[8 * kk + 2 * j + 1]);
      ph[kk][j] = __byte_perm(b0, b1, 0x7632);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          __uint_as_float(b0) - __uint_as_float(b0 & 0xffff0000u),
          __uint_as_float(b1) - __uint_as_float(b1 & 0xffff0000u));
      pl[kk][j] = *reinterpret_cast<const uint32_t*>(&lo);
    }
  }
}

// One work item of the wgmma instance: kWgRows packed query rows from r0
// of KV head hk of batch b, and the key tiles they can see.
struct WgItem {
  int b, hk, r0, p_first, p_last, t0, n_tiles;
};

// Work item `it` of (B * KV) x row tiles, the heaviest (last) row tiles
// first: the grid's blocks take items it, it + gridDim.x, ...
__device__ __forceinline__ WgItem wg_item(int it, int KV, int n_bkv,
                                          int n_rt, int group, int S,
                                          int causal, int window) {
  WgItem w;
  const int rt = n_rt - 1 - it / n_bkv;
  const int bkv = it - (it / n_bkv) * n_bkv;
  w.b = bkv / KV;
  w.hk = bkv - w.b * KV;
  w.r0 = rt * kWgRows;
  w.p_first = w.r0 / group;
  w.p_last = (min(w.r0 + kWgRows, S * group) - 1) / group;
  // key range that can hold a valid key for some row of the item
  const int k_end = causal ? w.p_last + 1 : S;
  const long long lo = (long long)w.p_first - window + 1;
  w.t0 = (lo > 0 ? (int)lo : 0) / kWgBN * kWgBN;
  w.n_tiles = (k_end - w.t0 + kWgBN - 1) / kWgBN;
  return w;
}

// NP: padded head width (wg_width); VEC: staged by cp.async (see tc_stage).
// Persistent: one block an SM walks its work items (wg_item), so the
// producer stages the next item's Q and first K/V tiles while the
// consumers finish the current one.
template <int NP, bool VEC>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, float* __restrict__ out, int B,
                int H, int group, int S, int hd, long long q_sb, long long q_sh,
                long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss, float scale,
                int causal, int window, float softcap) {
  constexpr int NST = wg_stages(NP);
  constexpr int QT = kWgBM * NP * 2;           // bytes of a warpgroup's Q
  constexpr int KT = kWgBN * NP * 2;           // bytes of a K or V tile
  constexpr int NO = NP / 2;                   // O accumulator registers
  constexpr int NS = kWgBN / 2;                // S accumulator registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // two Q buffers of kWgConsumers tiles, the K/V ring (stage s: K, then
  // V), then 8-byte mbarriers: full and empty a stage, full and empty a
  // Q buffer
  const uint32_t kv_s = base + 2 * kWgConsumers * QT;
  const uint32_t full_bar = kv_s + 2 * NST * KT;
  const uint32_t empty_bar = full_bar + 8 * NST;
  const uint32_t q_full = empty_bar + 8 * NST;
  const uint32_t q_empty = q_full + 16;

  const int KV = H / group;
  const int n_bkv = B * KV;
  const int n_rt = (S * group + kWgRows - 1) / kWgRows;
  const int n_items = n_bkv * n_rt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full_bar + 8 * s, 128);                // the producer's threads
      mbar_init(empty_bar + 8 * s, 4 * kWgConsumers);  // consumer warps
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + 8 * s, 128);
      mbar_init(q_empty + 8 * s, 4 * kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  if (wg == kWgConsumers) {
    // producer warpgroup: each item's Q into a free Q buffer, then its K/V
    // tiles into the ring, a stage once its last reader is done
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(kWgProducerRegs));
    int g = 0;  // tiles staged so far, over all items
    for (int it = blockIdx.x, j = 0; it < n_items; it += gridDim.x, ++j) {
      const WgItem w = wg_item(it, KV, n_bkv, n_rt, group, S, causal, window);
      const int qb = j & 1;
      if (j >= 2) mbar_wait(q_empty + 8 * qb, (j / 2 - 1) & 1);
      wg_stage_q<NP, VEC>(base + qb * kWgConsumers * QT,
                          smem + qb * kWgConsumers * QT,
                          q + w.b * q_sb + w.hk * group * q_sh, w.r0, group, S,
                          hd, q_sh, q_ss, t);
      if (VEC) {
        mbar_arrive_cp_async(q_full + 8 * qb);
      } else {
        fence_proxy_async();
        mbar_arrive(q_full + 8 * qb);
      }
      const bf16* kb = k + w.b * k_sb + w.hk * k_sh;
      const bf16* vb = v + w.b * v_sb + w.hk * v_sh;
      for (int i = 0; i < w.n_tiles; ++i, ++g) {
        const int s = g % NST;
        if (g >= NST) mbar_wait(empty_bar + 8 * s, (g / NST - 1) & 1);
        const int k0 = w.t0 + i * kWgBN;
        const uint32_t off = (uint32_t)(2 * s * KT);
        wg_stage_kv<NP, VEC>(kv_s + off, smem + (kv_s - base) + off, kb, k0,
                             S, hd, k_ss, t);
        wg_stage_kv<NP, VEC>(kv_s + off + KT, smem + (kv_s - base) + off + KT,
                             vb, k0, S, hd, v_ss, t);
        if (VEC) {
          mbar_arrive_cp_async(full_bar + 8 * s);
        } else {
          fence_proxy_async();
          mbar_arrive(full_bar + 8 * s);
        }
      }
    }
    if (VEC) cp_async_wait_all();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               ::"n"(kWgConsumerRegs));

  // consumer warpgroup wg: packed rows r0 + 64 wg .. + 63 of each item
  const int warp = t >> 5;
  const int lane = t & 31;
  const float mul = softcap > 0.0f ? 1.0f : scale * kLog2e;
  // The two warpgroups take turns to issue their products (named barriers
  // 3 and 4, warpgroup 0 first), so one's softmax runs while the other's
  // products are on the tensor cores.
  const int my_turn = 3 + wg, next_turn = 4 - wg;
  if (wg == 1) bar_arrive(next_turn, 256);
  int g = 0;  // tiles consumed so far, over all items
  for (int it = blockIdx.x, j = 0; it < n_items; it += gridDim.x, ++j) {
    const WgItem w = wg_item(it, KV, n_bkv, n_rt, group, S, causal, window);
    const int qb = j & 1;
    // this thread's packed rows (the accumulator's row and row + 8) and
    // their positions
    const int pr = w.r0 + wg * kWgBM + warp * 16 + (lane >> 2);
    const int pos[2] = {pr / group, (pr + 8) / group};
    const uint64_t q_desc =
        wg_desc(base + (qb * kWgConsumers + wg) * QT, 16, 1024);

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};  // running maxima, log2 units
    float l[2] = {0.0f, 0.0f};        // this thread's share of the sums
    float corr[2];
    float sc[NS];                     // S of the current tile
    uint32_t ph[kWgBN / 16][4], pl[kWgBN / 16][4];  // P of the previous tile

    // Tile i's logits, masks and softmax; `full`: no logit of it is
    // masked.  Each branch is taken or not for the whole item.
    auto softmax = [&](int k0) {
      const bool full = k0 + kWgBN <= S &&
                        (!causal || k0 + kWgBN - 1 <= w.p_first) &&
                        w.p_last - k0 < window;
      if (softcap > 0.0f) wg_softcap(sc, scale, softcap);
      if (!full) wg_mask(sc, k0, lane, pos, S, causal, window);
      wg_softmax(sc, m, l, corr, mul);
    };

    // Software pipeline: S_i = Q . K_i^T is issued together with
    // O += P_{i-1} . V_{i-1}, and the softmax of S_i runs while the latter
    // is on the tensor cores; O is rescaled by tile i's correction once
    // P_{i-1} . V_{i-1} is done.  Tile 0's S and the last tile's P.V stand
    // outside the loop.
    mbar_wait(q_full + 8 * qb, (j / 2) & 1);
    mbar_wait(full_bar + 8 * (g % NST), (g / NST) & 1);
    fence_proxy_async();
    bar_sync(my_turn, 256);
    wgmma_fence();
    wg_qk<NP>(sc, q_desc, kv_s + 2 * (g % NST) * KT);
    wgmma_commit();
    bar_arrive(next_turn, 256);
    wgmma_wait<0>();
    wg_fence_regs(sc);
    softmax(w.t0);
    wg_split(sc, ph, pl);
    for (int i = 1; i < w.n_tiles; ++i) {
      const int s = (g + i) % NST;
      const int sp = (g + i - 1) % NST;
      mbar_wait(full_bar + 8 * s, ((g + i) / NST) & 1);
      fence_proxy_async();
      wg_fence_regs(o);
      bar_sync(my_turn, 256);
      wgmma_fence();
      wg_qk<NP>(sc, q_desc, kv_s + 2 * s * KT);
      wgmma_commit();
      wg_pv(o, ph, pl, kv_s + (2 * sp + 1) * KT);
      wgmma_commit();
      bar_arrive(next_turn, 256);
      wgmma_wait<1>();  // S_i landed; P_{i-1} . V_{i-1} may still run
      wg_fence_regs(sc);
      softmax(w.t0 + i * kWgBN);
      wgmma_wait<0>();  // P_{i-1} . V_{i-1} done: O and its stage are free
      wg_fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * sp);
      // once the row maxima settle, corr is exactly 1 for the whole warp
      if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
        for (int n = 0; n < NO / 4; ++n) {
          o[4 * n] *= corr[0];
          o[4 * n + 1] *= corr[0];
          o[4 * n + 2] *= corr[1];
          o[4 * n + 3] *= corr[1];
        }
      }
      wg_split(sc, ph, pl);
    }
    g += w.n_tiles;
    const int sl = (g - 1) % NST;
    wg_fence_regs(o);
    bar_sync(my_turn, 256);
    wgmma_fence();
    wg_pv(o, ph, pl, kv_s + (2 * sl + 1) * KT);
    wgmma_commit();
    // warpgroup 1 takes the last turn of all
    if (wg == 0 || it + (int)gridDim.x < n_items) bar_arrive(next_turn, 256);
    wgmma_wait<0>();
    wg_fence_regs(o);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty_bar + 8 * sl);
      mbar_arrive(q_empty + 8 * qb);  // every read of this Q is done
    }

    // O / l to rows (pos, head hk * group + pr % group) of the output
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (pos[r] >= S) continue;
      const int h = w.hk * group + (pr + 8 * r - pos[r] * group);
      const float inv = 1.0f / fmaxf(l[r], 1e-30f);
      float* orow = out + (((long long)w.b * H + h) * S + pos[r]) * hd;
#pragma unroll
      for (int n = 0; n < NO / 4; ++n) {
        const int d = 8 * n + 2 * (lane & 3);
        const float x0 = o[4 * n + 2 * r] * inv;
        const float x1 = o[4 * n + 2 * r + 1] * inv;
        if (d + 1 < hd && (hd & 1) == 0) {
          *reinterpret_cast<float2*>(orow + d) = make_float2(x0, x1);
        } else {
          if (d < hd) orow[d] = x0;
          if (d + 1 < hd) orow[d + 1] = x1;
        }
      }
    }
  }
}

template <int NP, bool VEC>
cudaError_t wg_launch(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int KV, int S, int hd, long long q_sb,
                      long long q_sh, long long q_ss, long long k_sb,
                      long long k_sh, long long k_ss, long long v_sb,
                      long long v_sh, long long v_ss, float scale, int causal,
                      int window, float softcap, cudaStream_t stream) {
  const long long items =
      (long long)B * KV * (((long long)S * (H / KV) + kWgRows - 1) / kWgRows);
  if (items > 0x7fffffffll) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t smem = wg_smem_bytes(hd);
  err = cudaFuncSetAttribute(flash_wg_kernel<NP, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (int)(items < sms ? items : sms);
  flash_wg_kernel<NP, VEC><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(out), B, H, H / KV, S,
      hd, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal,
      window, softcap);
  return cudaGetLastError();
}

cudaError_t wg_dispatch(const void* q, const void* k, const void* v, void* out,
                        int B, int H, int KV, int S, int hd, long long q_sb,
                        long long q_sh, long long q_ss, long long k_sb,
                        long long k_sh, long long k_ss, long long v_sb,
                        long long v_sh, long long v_ss, float scale,
                        int causal, int window, float softcap,
                        cudaStream_t stream) {
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = hd % 8 == 0 && al(q) && al(k) && al(v) &&
                   (q_sb | q_sh | q_ss | k_sb | k_sh | k_ss | v_sb | v_sh |
                    v_ss) % 8 == 0;
#define FLASH_WG_LAUNCH(NP)                                                   \
  return vec ? wg_launch<NP, true>(q, k, v, out, B, H, KV, S, hd, q_sb, q_sh, \
                                   q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,  \
                                   scale, causal, window, softcap, stream)    \
             : wg_launch<NP, false>(q, k, v, out, B, H, KV, S, hd, q_sb,      \
                                    q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, \
                                    v_ss, scale, causal, window, softcap,     \
                                    stream)
  if (wg_width(hd) == 64) FLASH_WG_LAUNCH(64);
  FLASH_WG_LAUNCH(128);
#undef FLASH_WG_LAUNCH
}

}  // namespace

// Which instance serves (dtype, hd): 3 the wgmma instance, 2 the f32
// tensor-core instance, 1 the tensor-core instance, 0 the CUDA-core
// instance, -1 none.  The one place the rule lives; mirrored by `instance`
// in kernels/flash_attention.py.
extern "C" int flash_attention_instance(int dtype, int hd) {
  if (hd <= 0 || (dtype != 0 && dtype != 1)) return -1;
  if (dtype == 0) return hd <= kTc32MaxHeadDim ? 2 : 0;
  if (hd <= kWgMaxHeadDim) return 3;
  return hd <= kTcMaxHeadDim ? 1 : 0;
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
  if (instance == 3)
    return wg_dispatch(q, k, v, out, B, H, KV, S, hd, q_sb, q_sh, q_ss, k_sb,
                       k_sh, k_ss, v_sb, v_sh, v_ss, scale, causal, window,
                       softcap, st);
  if (instance == 2)
    return tc_dispatch<float>(q, k, v, out, B, H, KV, S, hd, q_sb, q_sh, q_ss,
                              k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale,
                              causal, window, softcap, st);
  if (instance == 1)
    return tc_dispatch<bf16>(q, k, v, out, B, H, KV, S, hd, q_sb, q_sh, q_ss,
                             k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale,
                             causal, window, softcap, st);
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
