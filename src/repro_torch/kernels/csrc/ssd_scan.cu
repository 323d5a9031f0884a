// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan.py, wrapper `ssd_scan`).  The TPU kernel
// walks a sequential grid (batch, heads, chunks) and carries the float32
// (N x P) state across the chunks in VMEM scratch.  On the card blocks run
// in parallel and in no order, so the chunk dimension becomes a loop
// inside the block: one block per (batch, head), the state resident in
// shared memory for the whole sequence.
//
// Per chunk of L steps, with cum = cumsum(dt * a) (all exponents <= 0):
//   M[t,u]  = (c_t . b_u) * exp(cum_t - cum_u) * dt_u   for u <= t, else 0
//   y_t     = sum_u M[t,u] x_u + exp(cum_t) * (c_t @ state)
//   state   = exp(cum_L) * state + sum_u (b_u * exp(cum_L - cum_u) dt_u) x_u
// exp(cum_t - cum_u) overflows above the diagonal, so M is selected there,
// never multiplied by a zero mask (inf * 0 would be NaN).
//
// Bound: per chunk the four products do ~L*L*N + L*L*P + 2*L*N*P FMAs
// against L*(2P + 2N + 1) elements in and out, so at Zamba2's L = 128,
// N = P = 64 the scan is bound by operations.  This first version stages
// the chunk's x, b, c, dt and cum and the L x L score tile in shared
// memory as float32 (182 KB at L = 128, N = P = 64: the block opts in to
// more than 48 KB) and multiplies with scalar FMAs, one shared-memory
// load per FMA.  One block per (batch, head) fills only B*H SMs (128 of
// 132 for Zamba2 at batch 2), one block each; tensor-core products and a
// split of the chunk loop are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 512;

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

size_t shared_floats(int L, int N, int P) {
  // state [N][P], x [L][P], b [L][N+1], c [L][N], M [L][L+1],
  // cum, dt and w [L] each
  return (size_t)N * P + (size_t)L * P + (size_t)L * (N + 1) +
         (size_t)L * N + (size_t)L * (L + 1) + 3 * (size_t)L;
}

// x, y: [B*H, S, P]; dt: [B*H, S] float32; a: [H] float32;
// b, c: [B*G, S, N].  grid = B*H.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ b,
               const T* __restrict__ c, T* __restrict__ y, int h, int g,
               int s, int L, int N, int P) {
  extern __shared__ float sm[];
  float* st = sm;                  // [N][P] carried state
  float* xs = st + N * P;          // [L][P]
  float* bs = xs + L * P;          // [L][N+1]
  float* cs = bs + L * (N + 1);    // [L][N]
  float* ms = cs + L * N;          // [L][L+1]
  float* cum = ms + L * (L + 1);   // [L]
  float* dts = cum + L;            // [L]
  float* ws = dts + L;             // [L] exp(cum_L - cum_u) * dt_u

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int gi = bi * g + hi / (h / g);
  const float ah = a[hi];
  const T* xg = x + (size_t)bh * s * P;
  const float* dtg = dt + (size_t)bh * s;
  const T* bg = b + (size_t)gi * s * N;
  const T* cg = c + (size_t)gi * s * N;
  T* yg = y + (size_t)bh * s * P;
  const int tid = threadIdx.x;

  for (int i = tid; i < N * P; i += THREADS) st[i] = 0.f;

  for (int t0 = 0; t0 < s; t0 += L) {
    __syncthreads();  // the last chunk's reads of x, b, c, dt are done
    for (int i = tid; i < L * P; i += THREADS)
      xs[i] = to_f(xg[(size_t)t0 * P + i]);
    for (int i = tid; i < L * N; i += THREADS) {
      const int u = i / N, n = i % N;
      bs[u * (N + 1) + n] = to_f(bg[(size_t)t0 * N + i]);
      cs[i] = to_f(cg[(size_t)t0 * N + i]);
    }
    for (int u = tid; u < L; u += THREADS) dts[u] = dtg[t0 + u];
    __syncthreads();

    // cum = inclusive cumsum of dt * a, by the first warp: each lane sums
    // a run of consecutive steps, then the runs' totals are scanned.
    if (tid < 32) {
      const int per = (L + 31) / 32;
      const int lo = min(L, tid * per), hi = min(L, lo + per);
      float run = 0.f;
      for (int u = lo; u < hi; ++u) {
        run += dts[u] * ah;
        cum[u] = run;
      }
      float pre = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, pre, o);
        if (tid >= o) pre += up;
      }
      const float before = pre - run;
      for (int u = lo; u < hi; ++u) cum[u] += before;
    }
    __syncthreads();

    const float cum_last = cum[L - 1];
    for (int u = tid; u < L; u += THREADS)
      ws[u] = expf(cum_last - cum[u]) * dts[u];
    for (int i = tid; i < L * L; i += THREADS) {
      const int t = i / L, u = i % L;
      float v = 0.f;
      if (u <= t) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n)
          dot += cs[t * N + n] * bs[u * (N + 1) + n];
        v = dot * expf(cum[t] - cum[u]) * dts[u];
      }
      ms[t * (L + 1) + u] = v;
    }
    __syncthreads();

    for (int i = tid; i < L * P; i += THREADS) {
      const int t = i / P, p = i % P;
      float acc = 0.f;
      for (int u = 0; u <= t; ++u) acc += ms[t * (L + 1) + u] * xs[u * P + p];
      float inc = 0.f;
      for (int n = 0; n < N; ++n) inc += cs[t * N + n] * st[n * P + p];
      yg[(size_t)(t0 + t) * P + p] = from_f<T>(acc + expf(cum[t]) * inc);
    }
    __syncthreads();  // every read of the incoming state is done

    const float decay = expf(cum_last);
    for (int i = tid; i < N * P; i += THREADS) {
      const int n = i / P, p = i % P;
      float acc = 0.f;
      for (int u = 0; u < L; ++u)
        acc += bs[u * (N + 1) + n] * ws[u] * xs[u * P + p];
      st[i] = decay * st[i] + acc;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, void* y, int batch, int h,
                   int g, int s, int L, int N, int P, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * shared_floats(L, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<batch * h, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), h, g, s, L, N, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

long long ssd_scan_shared_bytes(int L, int N, int P) {
  return (long long)(sizeof(float) * shared_floats(L, N, P));
}

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y alike; dt and a are
// float32).  Returns cudaGetLastError() after the launch as an int.
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* b, const void* c, void* y, int batch, int h,
                    int g, int s, int L, int N, int P, int dtype,
                    void* stream) {
  (void)cudaGetLastError();  // clear any stale error before this launch
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch<float>(x, dt, a, b, c, y, batch, h, g, s, L, N, P,
                                 st)
                 : launch<__nv_bfloat16>(x, dt, a, b, c, y, batch, h, g, s,
                                         L, N, P, st);
  return static_cast<int>(err);
}

}  // extern "C"
