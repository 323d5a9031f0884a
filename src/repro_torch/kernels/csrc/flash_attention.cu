// Flash attention forward for Hopper (sm_90a): causal / bidirectional,
// GQA, sliding window, queries at the kv tail.
//
// Replaces the reference's Pallas kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py, wrapper `flash_attention`).  The
// TPU kernel walks a sequential grid (batch*heads, q blocks, kv blocks)
// and carries the float32 online-softmax state (m, l, acc) across the kv
// steps in VMEM scratch.  On the card the blocks run in parallel and in no
// order, so the kv dimension becomes a loop inside the block: one block
// per (batch*head, 64-row query tile), with the running state in
// registers.
//
// Bound: at the main path's shapes (Zamba2 scoring, 2 x 32 heads x 4096
// tokens, d 64) attention does ~2*S/d operations per byte of q/k/v/o, far
// above the card's ~295 bf16 operations per byte: it is bound by
// operations.  This first version stages the q tile and each k/v tile in
// shared memory as float32 and multiplies with scalar FMAs, each thread
// holding a row's 16 scores and a quarter of its output row in registers
// (one shared-memory load per FMA).  It reaches the float32 FMA pipes,
// not the tensor cores; mma.sync / wgmma with TMA-fed tiles are later
// work.  Tiles wholly above the causal diagonal or outside the window are
// never loaded, as the reference skips them.
//
// Numerics follow the reference kernel: scores and softmax in float32,
// masked scores set to -1e30 and their probabilities to exactly 0, the
// output divided by l only where l > 0 (a fully masked row gives 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int COLS = BK / TPR;  // scores per thread per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int hq, int hkv, int sq, int skv, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = shared_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, batch * hq);
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, int batch, int hq, int hkv, int sq, int skv,
                     int causal, int window, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, batch, hq, hkv, sq, skv, causal,
                           window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, batch, hq, hkv, sq, skv, causal,
                           window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, hq, hkv, sq, skv, causal,
                           window, scale, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, batch, hq, hkv, sq, skv, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, hq, hkv, sq, skv, causal,
                            window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  cudaError_t err =
      dtype == 0
          ? dispatch<float>(d, q, k, v, o, batch, hq, hkv, sq, skv, causal,
                            window, scale, s)
          : dispatch<__nv_bfloat16>(d, q, k, v, o, batch, hq, hkv, sq, skv,
                                    causal, window, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
