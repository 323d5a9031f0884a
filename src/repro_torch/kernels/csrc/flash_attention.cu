// Flash attention forward for Hopper (sm_90a): causal / bidirectional,
// GQA, sliding window, queries at the kv tail.
//
// Replaces the reference's Pallas kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py, wrapper `flash_attention`).  The
// TPU kernel walks a sequential grid (batch*heads, q blocks, kv blocks)
// and carries the float32 online-softmax state (m, l, acc) across the kv
// steps in VMEM scratch.  On the card the blocks run in parallel and in no
// order, so the kv dimension becomes a loop inside the block, with the
// running state in registers.  Two instantiations, chosen by dtype:
//
// bfloat16 (`tc::flash_kernel`, the model's path).  Bound: at the main
// path's shapes (Zamba2 scoring, 2 x 32 heads x 4096 tokens, d 64)
// attention does ~2*S/d operations per byte of q/k/v/o, far above the
// card's ~295 bf16 operations per byte, so it is bound by the tensor
// cores.  Both products run on them as mma.sync.m16n8k16 (bf16 in,
// float32 accumulators in registers): 128 query rows per block, one warp
// per 16 rows, Q loaded once into registers with ldmatrix, S = Q K^T and
// O += P V per 64-key tile, P taken from the S accumulators (their
// m16n8 fragment is the A fragment of the second product) and rounded to
// bfloat16 only as that product's operand.  The row max and sum combine
// the 4 lanes of a quad with two shuffles; the rescale by
// exp2(m_old - m_new) is applied to the accumulator fragments in place.
// K and V tiles stream through a two-stage ring in shared memory filled
// by cp.async (16-byte copies, zero-filled past the sequence end): tile
// j+1's copy is in flight while tile j's products run.  mma.sync rather
// than wgmma: one code path covers all five head widths (16, 32, 64, 80,
// 128) with the same fragment layouts and no TMA descriptors or
// 128-byte swizzles, which a 160-byte row (d 80) does not tile; instead
// each shared-memory row is padded by 16 bytes (d + 8 elements), which
// makes every ldmatrix phase conflict-free for all five widths.  wgmma
// (the rest of the tensor cores' rate) is later work.  Tiles wholly above
// the causal diagonal or before the window are never loaded, the
// per-element mask runs only on tiles that straddle the diagonal, the
// window edge or the sequence end, and the query tiles with the most kv
// work are launched first so causal blocks finish together.
//
// float32 (`fp32::flash_kernel`, phase 9's float32-compute check only):
// the port's first kernel, unchanged.  It stages float32 tiles in shared
// memory and multiplies with scalar FMAs; TF32 tensor cores would break
// its 2e-5 agreement with the plain version.  A bfloat16 call never
// reaches it.
//
// Numerics follow the reference kernel: scores and softmax in float32,
// masked scores set to -1e30 and their probabilities to exactly 0, the
// output divided by l only where l > 0 (a fully masked row gives 0).  The
// bfloat16 kernel computes exp(s*scale - m) as exp2(s*scale*log2(e) - m')
// and sums l from the float32 probabilities before their rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int COLS = BK / TPR;  // scores per thread per tile

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

template <int D>
constexpr size_t shared_bytes() {
  // q tile [BQ][D+1], k tile [BK][D+1], v tile [BK][D], p tile [BQ][BK+1]
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D +
                                  BQ * (BK + 1));
}

// q: [B*Hq, Sq, D], k/v: [B*Hkv, Skv, D], o: [B*Hq, Sq, D], contiguous.
// grid = (ceil(Sq / BQ), B*Hq).  window <= 0 means no window.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int skv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][D+1]
  float* ks = qs + BQ * (D + 1);     // [BK][D+1]
  float* vs = ks + BK * (D + 1);     // [BK][D]
  float* ps = vs + BK * D;           // [BQ][BK+1]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int group = hq / hkv;
  const int kvh = (bh / hq) * hkv + (bh % hq) / group;
  const T* qg = q + (size_t)bh * sq * D;
  const T* kg = k + (size_t)kvh * skv * D;
  const T* vg = v + (size_t)kvh * skv * D;
  T* og = o + (size_t)bh * sq * D;

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int off = skv - sq;  // queries sit at the kv tail
  const bool row_ok = q0 + row < sq;
  const int qp = q0 + row + off;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[r * (D + 1) + d] =
        q0 + r < sq ? to_f(qg[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  constexpr int DJ = (D + TPR - 1) / TPR;  // output columns per thread
  float acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;

  // The kv tiles this query tile needs: none wholly above the causal
  // diagonal, none wholly before the window of its first row.
  const int q_lo = q0 + off;
  const int q_hi = min(q0 + BQ, sq) - 1 + off;
  const int k_end = causal ? min(skv, q_hi + 1) : skv;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's k/v/p reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < skv;
      const size_t at = (size_t)(k0 + r) * D + d;
      ks[r * (D + 1) + d] = in ? to_f(kg[at]) : 0.f;
      vs[r * D + d] = in ? to_f(vg[at]) : 0.f;
    }
    __syncthreads();

    // Scores of this row's columns lane, lane + TPR, ...
    float s[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[j] = 0.f;
    const float* qrow = qs + row * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        s[j] += qv * ks[(lane + TPR * j) * (D + 1) + d];
    }
    unsigned ok = 0;
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int kp = k0 + lane + TPR * j;
      const bool in = row_ok && kp < skv && (!causal || kp <= qp) &&
                      (window <= 0 || kp > qp - window);
      s[j] = in ? s[j] * scale : NEG_INF;
      ok |= (unsigned)in << j;
      mt = fmaxf(mt, s[j]);
    }
    // The row's TPR threads are neighbouring lanes of one warp.
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    float rs = 0.f;
    float* prow = ps + row * (BK + 1);
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const float p = (ok >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      prow[lane + TPR * j] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    const float alpha = expf(m - m_new);
    l = alpha * l + rs;
    m = m_new;
    __syncwarp();  // the row's p values come from its own warp

    float pv[DJ];
#pragma unroll
    for (int j = 0; j < DJ; ++j) pv[j] = 0.f;
    for (int c = 0; c < BK; ++c) {
      const float p = prow[c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = lane + TPR * j;
        if (d < D) pv[j] += p * vs[c * D + d];
      }
    }
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[j] = acc[j] * alpha + pv[j];
  }

  if (row_ok) {
    const float inv = 1.f / (l > 0.f ? l : 1.f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = lane + TPR * j;
      if (d < D) og[(size_t)(q0 + row) * D + d] = from_f<T>(acc[j] * inv);
    }
  }
}


}  // namespace fp32

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async K/V ring
// ---------------------------------------------------------------------------
namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;
constexpr int BQ = 128;           // query rows per block
constexpr int BK = 64;            // keys per kv tile
constexpr int WARPS = BQ / 16;    // one warp per 16 query rows
constexpr int THREADS = 32 * WARPS;

template <int D>
__host__ __device__ constexpr int ld() {  // padded shared-memory row, in elements
  return D + 8;
}

template <int D>
constexpr size_t shared_bytes() {
  // q [BQ][ld], k and v [2 stages][BK][ld]
  return sizeof(bf16) * (size_t)ld<D>() * (BQ + 4 * BK);
}

// Rows [r0, r0 + ROWS) of a contiguous [n, D] matrix into shared memory
// [ROWS][ld], zero past row n.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int r0,
                                          int n, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < n;
    cp_async16(smem_u32(s + r * ld<D>() + c * 8),
               g + (size_t)(in ? r0 + r : 0) * D + c * 8, in);
  }
}

__device__ __forceinline__ bool visible(int kp, int qp, int skv, int causal,
                                        int window) {
  return kp < skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// One kv tile's softmax update and P V product for a warp's 16 rows.  s
// holds the raw scores of rows g (elements 0, 1) and g + 8 (2, 3) of the
// quad at key columns 8*nt + 2t (+1).  MASK applies the per-element mask.
template <int D, bool MASK>
__device__ __forceinline__ void softmax_pv(
    float (&s)[BK / 8][4], float (&acc)[D / 8][4], float (&m)[2],
    float (&l)[2], uint32_t vst, int lane, int k0, int qp0, int skv,
    int causal, int window, float scale_log2) {
  const int t = lane & 3;
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * scale_log2;
      if (MASK) {
        const int kp = k0 + nt * 8 + 2 * t + (e & 1);
        const int qp = qp0 + (e >> 1) * 8;
        if (!visible(kp, qp, skv, causal, window)) x = NEG_INF;
      }
      s[nt][e] = x;
      mt[e >> 1] = fmaxf(mt[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
    mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
    const float mn = fmaxf(m[h], mt[h]);
    alpha[h] = exp2f(m[h] - mn);
    m[h] = mn;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e >> 1];

  // P as the A fragments of the second product: key columns 16kk..16kk+15
  // are S tiles 2kk (a0, a1) and 2kk + 1 (a2, a3).
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // A masked score is exactly NEG_INF; its probability is exactly 0.
      p[e] = (MASK && s[nt][e] == NEG_INF) ? 0.f
                                           : exp2f(s[nt][e] - m[e >> 1]);
      l[e >> 1] += p[e];
    }
    pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
    pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
  // O += P V: B fragments of V (keys x d) through ldmatrix.trans.
  const int i = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      const int key = kk * 16 + (i & 1) * 8 + (lane & 7);
      const int col = (2 * dp + (i >> 1)) * 8;
      ldsm_x4_t(b, vst + 2 * (key * ld<D>() + col));
      mma(acc[2 * dp], pf[kk], b[0], b[1]);
      mma(acc[2 * dp + 1], pf[kk], b[2], b[3]);
    }
}

// q: [B*Hq, Sq, D], k/v: [B*Hkv, Skv, D], o: [B*Hq, Sq, D], contiguous.
// grid = (B*Hq, ceil(Sq / BQ)); blockIdx.y counts query tiles from the
// last (the most kv tiles under a causal mask) to the first.
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int hq,
                 int hkv, int sq, int skv, int causal, int window,
                 float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][ld]
  bf16* ks = qs + BQ * ld<D>();                   // [2][BK][ld]
  bf16* vs = ks + 2 * BK * ld<D>();               // [2][BK][ld]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int group = hq / hkv;
  const int kvh = (bh / hq) * hkv + (bh % hq) / group;
  const bf16* qg = q + (size_t)bh * sq * D;
  const bf16* kg = k + (size_t)kvh * skv * D;
  const bf16* vg = v + (size_t)kvh * skv * D;
  bf16* og = o + (size_t)bh * sq * D;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = skv - sq;  // queries sit at the kv tail
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0+8
  const int qp0 = row0 + off;

  // The kv tiles this query tile needs: none wholly above the causal
  // diagonal, none wholly before the window of its first row.
  const int q_lo = q0 + off;
  const int q_hi = min(q0 + BQ, sq) - 1 + off;
  const int k_end = causal ? min(skv, q_hi + 1) : skv;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  load_tile<D, BQ>(qs, qg, q0, sq, tid);
  if (n_tiles > 0) {
    load_tile<D, BK>(ks, kg, k_begin, skv, tid);
    load_tile<D, BK>(vs, vg, k_begin, skv, tid);
  }
  cp_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int i = lane >> 3;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * BK;
    if (j + 1 < n_tiles) {  // the next tile's copy overlaps this tile
      const int nb = (j + 1) & 1;
      load_tile<D, BK>(ks + nb * BK * ld<D>(), kg, k0 + BK, skv, tid);
      load_tile<D, BK>(vs + nb * BK * ld<D>(), vg, k0 + BK, skv, tid);
    }
    cp_commit();
    cp_wait<1>();  // everything but the copy just issued has landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int r = warp * 16 + (i & 1) * 8 + (lane & 7);
        ldsm_x4(qf[kk], smem_u32(qs + r * ld<D>() + kk * 16 + (i >> 1) * 8));
      }
    }
    const uint32_t kst = smem_u32(ks + (j & 1) * BK * ld<D>());
    const uint32_t vst = smem_u32(vs + (j & 1) * BK * ld<D>());

    // S = Q K^T: B fragments of K (keys x d) straight from its rows.
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        const int key = (2 * np + (i >> 1)) * 8 + (lane & 7);
        const int col = kk * 16 + (i & 1) * 8;
        ldsm_x4(b, kst + 2 * (key * ld<D>() + col));
        mma(s[2 * np], qf[kk], b[0], b[1]);
        mma(s[2 * np + 1], qf[kk], b[2], b[3]);
      }

    // Per-element masking only where the tile straddles the diagonal, the
    // window's edge or the end of the keys.
    const bool full = k0 + BK <= skv && (!causal || k0 + BK - 1 <= q_lo) &&
                      (window <= 0 || k0 > q_hi - window);
    if (full)
      softmax_pv<D, false>(s, acc, m, l, vst, lane, k0, qp0, skv, causal,
                           window, scale_log2);
    else
      softmax_pv<D, true>(s, acc, m, l, vst, lane, k0, qp0, skv, causal,
                          window, scale_log2);
    __syncthreads();  // this stage is free before the next copy into it
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float inv = 1.f / (l[h] > 0.f ? l[h] : 1.f);
    const int row = row0 + h * 8;
    if (row < sq) {
      uint32_t* orow = reinterpret_cast<uint32_t*>(og + (size_t)row * D);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        orow[dt * 4 + t] =
            pack_bf16(acc[dt][2 * h] * inv, acc[dt][2 * h + 1] * inv);
    }
  }
}

}  // namespace tc

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int batch, int hq, int hkv, int sq, int skv,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr size_t bytes = fp32::shared_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fp32::flash_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + fp32::BQ - 1) / fp32::BQ, batch * hq);
  fp32::flash_kernel<float, D><<<grid, fp32::THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq, skv,
      causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int batch, int hq, int hkv, int sq, int skv,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  constexpr size_t bytes = tc::shared_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      tc::flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * hq, (sq + tc::BQ - 1) / tc::BQ);
  tc::flash_kernel<D><<<grid, tc::THREADS, bytes, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), hq, hkv,
      sq, skv, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, int batch, int hq, int hkv, int sq, int skv,
                   int causal, int window, float scale,
                   cudaStream_t stream) {
  return dtype == 0 ? launch_f32<D>(q, k, v, o, batch, hq, hkv, sq, skv,
                                    causal, window, scale, stream)
                    : launch_bf16<D>(q, k, v, o, batch, hq, hkv, sq, skv,
                                     causal, window, scale, stream);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  Returns
// cudaGetLastError() after the launch as an int (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int batch, int hq, int hkv, int sq,
                           int skv, int d, int causal, int window,
                           float scale, int dtype, void* stream) {
  (void)cudaGetLastError();  // clear any stale error before this launch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(dtype, q, k, v, o, batch, hq, hkv, sq, skv, causal,
                        window, scale, s);
    case 32:
      return launch<32>(dtype, q, k, v, o, batch, hq, hkv, sq, skv, causal,
                        window, scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, batch, hq, hkv, sq, skv, causal,
                        window, scale, s);
    case 80:
      return launch<80>(dtype, q, k, v, o, batch, hq, hkv, sq, skv, causal,
                        window, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, batch, hq, hkv, sq, skv, causal,
                         window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
