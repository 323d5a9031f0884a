// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan.py, wrapper `ssd_scan`).  The TPU kernel
// walks a sequential grid (batch, heads, chunks) and carries the float32
// (N x P) state across the chunks in VMEM scratch.  On the card blocks run
// in parallel and in no order, so the chunk dimension becomes a loop
// inside the block, the state resident in the block for the whole
// sequence.
//
// Per chunk of L steps, with cum = cumsum(dt * a) (all exponents <= 0):
//   M[t,u]  = (c_t . b_u) * exp(cum_t - cum_u) * dt_u   for u <= t, else 0
//   y_t     = sum_u M[t,u] x_u + exp(cum_t) * (c_t @ state)
//   state   = exp(cum_L) * state + sum_u (b_u * exp(cum_L - cum_u) dt_u) x_u
// exp(cum_t - cum_u) overflows above the diagonal, so M is selected there,
// never multiplied by a zero mask (inf * 0 would be NaN).
//
// Two kernels, chosen by dtype:
//
// bfloat16 (`tc::ssd_kernel`, the model's path).  Bound: at Zamba2's
// scoring shape (2 x 64 heads x 4096 steps, P = N = 64, chunk 128) the
// four products need 25.8 GFLOP (the causal triangle only), 0.026 ms at
// the dense bf16 tensor-core rate, against 138 MB of x, b, c, y, dt
// (x read and y written once dominate), 0.041 ms at 3.35 TB/s: the scan
// is bound by bytes.  The scalar kernel ran at 1.3 % of that bound; the
// design puts every product on the tensor cores and keeps the chunk loop
// fed:
// - x, b and c stay bfloat16 in shared memory, rows padded by 16 bytes so
//   that every ldmatrix phase is conflict-free, filled by 16-byte
//   cp.async copies in a two-stage ring: chunk c+1's tiles and dt are in
//   flight while chunk c's products run.  Per chunk one block barrier
//   publishes the tiles; one warp then scans dt into the decays while the
//   others issue the next copies and publish the incoming state, and a
//   second barrier publishes both.
// - All four products run as mma.sync.m16n8k16 with float32 accumulators
//   in registers.  One warp per 16-row strip of t starts from C state_in,
//   then computes S = C B^T below the diagonal only, two 16x16 tiles at a
//   time, turns the accumulators into M in place (the per-element select
//   only on the diagonal tile) and feeds them straight back as the A
//   fragments of M X.  Strips are dealt so that the two warps of each SM
//   sub-partition hold a short and a long one.  The state update B^T (w x)
//   takes B^T through ldmatrix.trans of the b tile.
// - The operands the kernel computes rather than reads (M, the carried
//   state and b * w) go to the tensor cores as bf16 hi + lo halves, two
//   products each: the plain version keeps them in float32, outputs are
//   sums of terms far larger than themselves, and one bf16 rounding of
//   any of the three leaves the output outside its 2e-2 tolerance at
//   Zamba2's shape (tests/test_torch_kernels_hopper.py emulates both
//   schemes on the CPU).  The halves are cut by truncation with integer
//   ops (error < 2^-14), which measured faster than rounding conversions;
//   x, b and c are exact in bf16.  Exponentials run on ex2.approx.
// - The state stays float32 in the registers of the warps that own its
//   16x16 tiles; at each chunk they publish it as the hi and lo tiles.
// - The P columns of the state (and of x and y) split over k blocks per
//   (batch, head), each carrying N x P/k of the state and recomputing
//   C B^T and M; ssd_scan.plan picks k by measured time (k = 1 when the
//   (batch, head) pairs fill the card).  Chunk lengths and widths that
//   do not tile by 16 are zero-padded in shared memory (a zero row of b,
//   c or x adds nothing; rows and columns past the chunk are never
//   stored).
// mma.sync rather than wgmma, as in flash_attention.cu: one code path for
// every (N, P/k) and no TMA descriptors; wgmma and TMA are later work.
//
// float32 (`fp32::ssd_kernel`, the float32-compute checks only): the
// port's first kernel.  It stages float32 tiles and the L x L score tile
// in shared memory and multiplies with scalar FMAs; TF32 tensor cores
// would break its 3e-4 agreement with the plain version.  As the bfloat16
// kernel does, it splits the P columns of the state, x and y over k
// blocks per (batch, head), each recomputing the score tile: at chunk
// 128, N 128, P 64 (mamba2-1.3b) one block's tiles are 264 704 bytes,
// past the 232 448 a block may take, and at k = 2 they are 231 936.
// ssd_scan.plan takes the smallest k that fits (k = 1 at d_state 64).  A
// bfloat16 call never reaches it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "mma_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int THREADS = 512;

size_t shared_floats(int L, int N, int W) {
  // state [N][W], x [L][W], b [L][N+1], c [L][N], M [L][L+1],
  // cum, dt and w [L] each; W = P / k columns a block
  return (size_t)N * W + (size_t)L * W + (size_t)L * (N + 1) +
         (size_t)L * N + (size_t)L * (L + 1) + 3 * (size_t)L;
}

// x, y: [B*H, S, P]; dt: [B*H, S] float32; a: [H] float32;
// b, c: [B*G, S, N].  grid = B*H*k; block j of a (batch, head) owns the
// W = P / k columns from j * W.
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ c, float* __restrict__ y, int h,
               int g, int s, int L, int N, int P, int k) {
  extern __shared__ float sm[];
  const int W = P / k;
  float* st = sm;                  // [N][W] carried state
  float* xs = st + N * W;          // [L][W]
  float* bs = xs + L * W;          // [L][N+1]
  float* cs = bs + L * (N + 1);    // [L][N]
  float* ms = cs + L * N;          // [L][L+1]
  float* cum = ms + L * (L + 1);   // [L]
  float* dts = cum + L;            // [L]
  float* ws = dts + L;             // [L] exp(cum_L - cum_u) * dt_u

  const int bh = blockIdx.x / k;
  const int p0 = (blockIdx.x % k) * W;
  const int bi = bh / h, hi = bh % h;
  const int gi = bi * g + hi / (h / g);
  const float ah = a[hi];
  const float* xg = x + (size_t)bh * s * P + p0;
  const float* dtg = dt + (size_t)bh * s;
  const float* bg = b + (size_t)gi * s * N;
  const float* cg = c + (size_t)gi * s * N;
  float* yg = y + (size_t)bh * s * P + p0;
  const int tid = threadIdx.x;

  for (int i = tid; i < N * W; i += THREADS) st[i] = 0.f;

  for (int t0 = 0; t0 < s; t0 += L) {
    __syncthreads();  // the last chunk's reads of x, b, c, dt are done
    for (int i = tid; i < L * W; i += THREADS)
      xs[i] = xg[(size_t)(t0 + i / W) * P + i % W];
    for (int i = tid; i < L * N; i += THREADS) {
      const int u = i / N, n = i % N;
      bs[u * (N + 1) + n] = bg[(size_t)t0 * N + i];
      cs[i] = cg[(size_t)t0 * N + i];
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

    for (int i = tid; i < L * W; i += THREADS) {
      const int t = i / W, p = i % W;
      float acc = 0.f;
      for (int u = 0; u <= t; ++u) acc += ms[t * (L + 1) + u] * xs[u * W + p];
      float inc = 0.f;
      for (int n = 0; n < N; ++n) inc += cs[t * N + n] * st[n * W + p];
      yg[(size_t)(t0 + t) * P + p] = acc + expf(cum[t]) * inc;
    }
    __syncthreads();  // every read of the incoming state is done

    const float decay = expf(cum_last);
    for (int i = tid; i < N * W; i += THREADS) {
      const int n = i / W, p = i % W;
      float acc = 0.f;
      for (int u = 0; u < L; ++u)
        acc += bs[u * (N + 1) + n] * ws[u] * xs[u * W + p];
      st[i] = decay * st[i] + acc;
    }
  }
}

bool takes(int P, int k) { return k >= 1 && P % k == 0; }

cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, void* y, int batch, int h,
                   int g, int s, int L, int N, int P, int k,
                   cudaStream_t stream) {
  if (!takes(P, k)) return cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * shared_floats(L, N, P / k);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_kernel<<<batch * h * k, THREADS, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y), h, g, s, L, N,
      P, k);
  return cudaGetLastError();
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async tile ring
// ---------------------------------------------------------------------------
namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// The state's rows are padded to one of these (N <= 256), a block's
// columns (P / k) to one of 16, 32, 64.
__host__ int state_rows(int n) {
  for (int r = 16; r <= 256; r *= 2)
    if (n <= r) return r;
  return 0;
}
__host__ int tile_width(int pc) {
  for (int w = 16; w <= 64; w *= 2)
    if (pc <= w) return w;
  return 0;
}

// Dynamic shared memory of a block, mirrored by ssd_scan.shared_bytes:
// x [2][LP][W+8], b and c [2][LP][NP+8] each, the state's hi and lo
// halves [NP][W+8] each (all bf16), dt [2][LP], and cum * log2 e,
// exp(cum) and w [3][LP] (float32).
__host__ size_t shared_bytes(int lp, int np, int w) {
  return 4 * (size_t)lp * (w + 8) + 8 * (size_t)lp * (np + 8) +
         4 * (size_t)np * (w + 8) + 20 * (size_t)lp;
}

// Async copy of 4 bytes, zero-filled when !in.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}

// Rows [0, lp) of a chunk's tile into shared memory [lp][LD]: row r < L
// from g + r * stride, its 16-byte chunks below `valid` of the CPR per
// row; zeros elsewhere.
template <int CPR, int LD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int stride,
                                          int L, int lp, int valid, int tid) {
  for (int i = tid; i < lp * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool in = r < L && c < valid;
    cp_async16(smem_u32(s + r * LD + c * 8),
               in ? g + (size_t)r * stride + c * 8 : g, in);
  }
}

// hi + lo bf16 halves of (v0, v1), packed, by truncation (integer and
// byte-permute ops, no conversion unit): hi keeps each float's upper 16
// bits, v - hi is exact in float32 and lo keeps its upper 16 bits, so
// |v - hi - lo| < 2^-14 |v|.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const uint32_t a = __float_as_uint(v0), b = __float_as_uint(v1);
  hi = __byte_perm(a, b, 0x7632);
  const float l0 = v0 - __uint_as_float(a & 0xffff0000u);
  const float l1 = v1 - __uint_as_float(b & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
}

// 2^x on the special function unit (relative error ~2^-22; results below
// 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The chunk's decays, by one warp from its dt: cum as the float32 kernel
// sums it (each lane a run of consecutive steps, then the runs' totals
// scanned, each step's cum its run's partial sum plus the runs before),
// then per step u < lp: cum * log2 e, exp(cum) and w = exp(cum_L - cum_u)
// * dt_u; steps past L take cum_L and w = 0.
__device__ __forceinline__ void chunk_decay(const float* dts, float ah,
                                            int L, int lp, float* c2,
                                            int lane) {
  float* ec = c2 + lp;
  float* wv = ec + lp;
  const int per = (L + 31) / 32;
  const int lo = min(L, lane * per), hi = min(L, lo + per);
  float run = 0.f;
  for (int u = lo; u < hi; ++u) run += dts[u] * ah;
  float pre = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, pre, o);
    if (lane >= o) pre += up;
  }
  const float before = pre - run;
  // cum_L, as the lane that holds step L - 1 sums it
  const float last =
      __shfl_sync(0xffffffffu, run + before, (L - 1) / per) * LOG2E;
  run = 0.f;
  for (int u = lo; u < hi; ++u) {
    run += dts[u] * ah;
    const float cu = (run + before) * LOG2E;
    c2[u] = cu;
    ec[u] = ex2(cu);
    wv[u] = ex2(last - cu) * dts[u];
  }
  for (int u = L + lane; u < lp; u += 32) {
    c2[u] = last;
    ec[u] = ex2(last);
    wv[u] = 0.f;
  }
}

// S = C B^T for NT consecutive 16x16 tiles j, j + 1 of a strip: B
// fragments of b (u x n) straight from its rows.  The tiles' chains run
// interleaved.
template <int MT, int LDN, int NT>
__device__ __forceinline__ void s_tiles(float (&sa)[NT][2][4],
                                        const uint32_t (&cf)[MT][4],
                                        const bf16* bc, int j, int lane) {
  const int i8 = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[t][hh][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < MT; ++kk) {
    uint32_t bb[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
      ldsm_x4(bb[t], smem_u32(bc + (16 * (j + t) + (i8 >> 1) * 8 + r8) * LDN +
                              16 * kk + (i8 & 1) * 8));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int t = 0; t < NT; ++t)
        mma(sa[t][hh], cf[kk], bb[t][2 * hh], bb[t][2 * hh + 1]);
  }
}

// M = S * exp(cum_t - cum_u) * dt_u on tile j's accumulators (this
// thread's rows t_lo (e 0, 1) and t_lo + 8 (e 2, 3), columns 16j + 8hh +
// 2t (+1)), selected to 0 above the diagonal on the diagonal tile, as the
// A fragments (hi, lo) of M X.  c2 holds cum * log2 e.
template <bool DIAG>
__device__ __forceinline__ void m_tile(const float (&sa)[2][4],
                                       const float* c2, const float* dc,
                                       int j, float ct0, float ct1, int lane,
                                       uint32_t (&mh)[4], uint32_t (&ml)[4]) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int u = 16 * j + 8 * hh + 2 * tq;
    const float2 cu = *reinterpret_cast<const float2*>(c2 + u);
    const float2 du = *reinterpret_cast<const float2*>(dc + u);
    float m0 = sa[hh][0] * ex2(ct0 - cu.x) * du.x;
    float m1 = sa[hh][1] * ex2(ct0 - cu.y) * du.y;
    float m2 = sa[hh][2] * ex2(ct1 - cu.x) * du.x;
    float m3 = sa[hh][3] * ex2(ct1 - cu.y) * du.y;
    if (DIAG) {  // select, never multiply: exp overflows above it
      const int ul = 8 * hh + 2 * tq;
      m0 = ul <= gq ? m0 : 0.f;
      m1 = ul + 1 <= gq ? m1 : 0.f;
      m2 = ul <= gq + 8 ? m2 : 0.f;
      m3 = ul + 1 <= gq + 8 ? m3 : 0.f;
    }
    split2(m0, m1, mh[2 * hh], ml[2 * hh]);
    split2(m2, m3, mh[2 * hh + 1], ml[2 * hh + 1]);
  }
}

// acc += M X over NT tiles j, j + 1: B fragments of x (u x p) through
// ldmatrix.trans; the hi products of every tile before the lo ones, so
// that no two consecutive products share an accumulator.
template <int PT, int LDW, int NT>
__device__ __forceinline__ void mx_tiles(float (&acc)[2 * PT][4],
                                         const uint32_t (&mh)[NT][4],
                                         const uint32_t (&ml)[NT][4],
                                         const bf16* xc, int j, int lane) {
  const int i8 = lane >> 3, r8 = lane & 7;
  uint32_t xf[NT][PT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int dp = 0; dp < PT; ++dp)
      ldsm_x4_t(xf[t][dp],
                smem_u32(xc + (16 * (j + t) + (i8 & 1) * 8 + r8) * LDW +
                         (2 * dp + (i8 >> 1)) * 8));
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int dp = 0; dp < PT; ++dp) {
      mma(acc[2 * dp], mh[t], xf[t][dp][0], xf[t][dp][1]);
      mma(acc[2 * dp + 1], mh[t], xf[t][dp][2], xf[t][dp][3]);
    }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int dp = 0; dp < PT; ++dp) {
      mma(acc[2 * dp], ml[t], xf[t][dp][0], xf[t][dp][1]);
      mma(acc[2 * dp + 1], ml[t], xf[t][dp][2], xf[t][dp][3]);
    }
}

// M X for the tiles j .. j + NT - 1 of a strip, the last one the diagonal
// tile when DIAG.
template <int MT, int PT, int LDN, int LDW, int NT, bool DIAG>
__device__ __forceinline__ void strip_tiles(
    float (&acc)[2 * PT][4], const uint32_t (&cf)[MT][4], const bf16* bc,
    const bf16* xc, const float* c2, const float* dc, int j, float ct0,
    float ct1, int lane) {
  float sa[NT][2][4];
  s_tiles<MT, LDN, NT>(sa, cf, bc, j, lane);
  uint32_t mh[NT][4], ml[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (DIAG && t == NT - 1)
      m_tile<true>(sa[t], c2, dc, j + t, ct0, ct1, lane, mh[t], ml[t]);
    else
      m_tile<false>(sa[t], c2, dc, j + t, ct0, ct1, lane, mh[t], ml[t]);
  }
  mx_tiles<PT, LDW, NT>(acc, mh, ml, xc, j, lane);
}

// x, y: [B*H, S, P]; dt: [B*H, S] float32; a: [H] float32;
// b, c: [B*G, S, N]; N and P multiples of 8, x, b, c and y 16-byte
// aligned.  grid = (B*H, k): block (bh, j) owns columns [j*pc, (j+1)*pc)
// of x, y and the state.  NP: the state's rows padded (>= N); W: a
// block's columns padded (>= pc).
template <int NP, int W>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const bf16* __restrict__ b,
               const bf16* __restrict__ c, bf16* __restrict__ y, int h,
               int g, int s, int L, int N, int P, int pc) {
  constexpr int LDN = NP + 8, LDW = W + 8;  // padded rows, in elements
  constexpr int MT = NP / 16, PT = W / 16;  // 16x16 tiles of the state
  // The state's tiles by warp: WPM warps share each 16-row tile, RM row
  // tiles and up to RP column tiles per warp.
  constexpr int WPM = MT >= WARPS ? 1 : WARPS / MT;
  constexpr int RM = MT >= WARPS ? MT / WARPS : 1;
  constexpr int RP = (PT + WPM - 1) / WPM;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lp = (L + 15) & ~15, ns = lp / 16;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [2][lp][LDW]
  bf16* bs = xs + 2 * lp * LDW;                   // [2][lp][LDN]
  bf16* cs = bs + 2 * lp * LDN;                   // [2][lp][LDN]
  bf16* sh = cs + 2 * lp * LDN;                   // [NP][LDW] state, hi
  bf16* sl = sh + NP * LDW;                       // [NP][LDW] state, lo
  float* dts = reinterpret_cast<float*>(sl + NP * LDW);  // [2][lp]
  float* c2 = dts + 2 * lp;  // [lp] cum * log2 e, then exp(cum) and w
  const float* ec = c2 + lp;
  const float* wv = ec + lp;

  const int bh = blockIdx.x, p0 = blockIdx.y * pc;
  const int bi = bh / h, hi = bh % h;
  const int gi = bi * g + hi / (h / g);
  const float ah = a[hi];
  const bf16* xg = x + (size_t)bh * s * P + p0;
  const float* dtg = dt + (size_t)bh * s;
  const bf16* bg = b + (size_t)gi * s * N;
  const bf16* cg = c + (size_t)gi * s * N;
  bf16* yg = y + (size_t)bh * s * P + p0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column
  const int i8 = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix and row
  const int nch = s / L;

  auto load = [&](int ch, int stage) {
    load_tile<W / 8, LDW>(xs + stage * lp * LDW, xg + (size_t)ch * L * P, P,
                          L, lp, pc / 8, tid);
    load_tile<NP / 8, LDN>(bs + stage * lp * LDN, bg + (size_t)ch * L * N,
                           N, L, lp, N / 8, tid);
    load_tile<NP / 8, LDN>(cs + stage * lp * LDN, cg + (size_t)ch * L * N,
                           N, L, lp, N / 8, tid);
    for (int u = tid; u < lp; u += THREADS)
      cp_async4(smem_u32(dts + stage * lp + u),
                dtg + (size_t)ch * L + (u < L ? u : 0), u < L);
    cp_commit();
  };

  // The state tiles this warp owns, float32 C fragments:
  // st[r][q][half] covers rows 16 * (mt0 + WARPS * r) + (g, g + 8) and
  // columns 16 * (sub + WPM * q) + 8 * half + (2t, 2t + 1).
  const int mt0 = MT >= WARPS ? warp : warp / WPM;
  const int sub = MT >= WARPS ? 0 : warp % WPM;
  float st[RM][RP][2][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < RP; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[r][q][hh][e] = 0.f;

  load(0, 0);

  for (int ch = 0; ch < nch; ++ch) {
    const int cur = ch & 1;
    cp_wait<0>();
    __syncthreads();  // chunk ch's tiles are in; chunk ch-1's reads of
                      // the other stage, the decays and the state are done
    if (warp == 0) chunk_decay(dts + cur * lp, ah, L, lp, c2, lane);
    if (ch + 1 < nch) load(ch + 1, cur ^ 1);

    // Publish the incoming state as bf16 hi and lo tiles.
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < RP; ++q) {
        const int pt = sub + WPM * q;
        if (pt >= PT) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int at = (16 * (mt0 + WARPS * r) + gq + 8 * e2) * LDW +
                           16 * pt + 8 * hh + 2 * tq;
            uint32_t vh, vl;
            split2(st[r][q][hh][2 * e2], st[r][q][hh][2 * e2 + 1], vh, vl);
            *reinterpret_cast<uint32_t*>(sh + at) = vh;
            *reinterpret_cast<uint32_t*>(sl + at) = vl;
          }
      }
    __syncthreads();  // the decays and the incoming state are published

    const bf16* xc = xs + cur * lp * LDW;
    const bf16* bc = bs + cur * lp * LDN;
    const bf16* cc = cs + cur * lp * LDN;
    const float* dc = dts + cur * lp;

    // y for the warp's strips of 16 rows.  Strip order pairs the warps of
    // one SM sub-partition (w, w + 4): strips w and 7 - w of each 8.
    for (int r = 0; r * WARPS < ns; ++r) {
      const int i = r * WARPS +
                    (warp < WARPS / 2 ? warp : 3 * WARPS / 2 - 1 - warp);
      if (i >= ns) continue;
      const int t_lo = 16 * i + gq;  // this thread's rows t_lo, t_lo + 8

      uint32_t cf[MT][4];  // C strip: the A operand of C B^T and C state
#pragma unroll
      for (int kk = 0; kk < MT; ++kk)
        ldsm_x4(cf[kk], smem_u32(cc + (16 * i + (i8 & 1) * 8 + r8) * LDN +
                                 16 * kk + (i8 >> 1) * 8));
      float acc[2 * PT][4];
#pragma unroll
      for (int nt = 0; nt < 2 * PT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

      // y = exp(cum_t) * (C state_in): B fragments of the state (n x p)
      // through ldmatrix.trans, the hi products before the lo ones.
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        uint32_t vh[PT][4], vl[PT][4];
#pragma unroll
        for (int dp = 0; dp < PT; ++dp) {
          const int at = (16 * kk + (i8 & 1) * 8 + r8) * LDW +
                         (2 * dp + (i8 >> 1)) * 8;
          ldsm_x4_t(vh[dp], smem_u32(sh + at));
          ldsm_x4_t(vl[dp], smem_u32(sl + at));
        }
#pragma unroll
        for (int dp = 0; dp < PT; ++dp) {
          mma(acc[2 * dp], cf[kk], vh[dp][0], vh[dp][1]);
          mma(acc[2 * dp + 1], cf[kk], vh[dp][2], vh[dp][3]);
        }
#pragma unroll
        for (int dp = 0; dp < PT; ++dp) {
          mma(acc[2 * dp], cf[kk], vl[dp][0], vl[dp][1]);
          mma(acc[2 * dp + 1], cf[kk], vl[dp][2], vl[dp][3]);
        }
      }
      const float e0 = ec[t_lo], e1 = ec[t_lo + 8];
#pragma unroll
      for (int nt = 0; nt < 2 * PT; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }

      // y += M X over the tiles j <= i of M, two at a time (their
      // products interleaved), the diagonal tile last.
      const float ct0 = c2[t_lo], ct1 = c2[t_lo + 8];
      int j = 0;
      for (; j + 1 < i; j += 2)
        strip_tiles<MT, PT, LDN, LDW, 2, false>(acc, cf, bc, xc, c2, dc, j,
                                                ct0, ct1, lane);
      if (j + 1 == i)
        strip_tiles<MT, PT, LDN, LDW, 2, true>(acc, cf, bc, xc, c2, dc, j,
                                               ct0, ct1, lane);
      else
        strip_tiles<MT, PT, LDN, LDW, 1, true>(acc, cf, bc, xc, c2, dc, j,
                                               ct0, ct1, lane);

      const size_t row0 = (size_t)ch * L + t_lo;
#pragma unroll
      for (int nt = 0; nt < 2 * PT; ++nt) {
        const int col = 8 * nt + 2 * tq;
        if (col >= pc) continue;
        if (t_lo < L)
          *reinterpret_cast<uint32_t*>(yg + row0 * P + col) =
              pack_bf16(acc[nt][0], acc[nt][1]);
        if (t_lo + 8 < L)
          *reinterpret_cast<uint32_t*>(yg + (row0 + 8) * P + col) =
              pack_bf16(acc[nt][2], acc[nt][3]);
      }
    }

    // state = exp(cum_L) * state + B^T (w x): A fragments of B^T (n x u)
    // through ldmatrix.trans of b, scaled by w and split hi + lo; even
    // and odd k-steps into two sums, so that the products' chains
    // interleave.
    const float decay = ec[L - 1];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int mt = mt0 + WARPS * r;
      float ua[2][RP][2][4];
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int q = 0; q < RP; ++q)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) ua[o][q][hh][e] = 0.f;
      if (sub < PT) {
        for (int ks = 0; ks < ns; ks += 2) {
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const int k0 = 16 * (ks + o);
            if (ks + o >= ns) break;
            uint32_t af[4], ah_[4], al_[4];
            ldsm_x4_t(af, smem_u32(bc + (k0 + (i8 >> 1) * 8 + r8) * LDN +
                                   16 * mt + (i8 & 1) * 8));
            const float2 w0 =
                *reinterpret_cast<const float2*>(wv + k0 + 2 * tq);
            const float2 w1 =
                *reinterpret_cast<const float2*>(wv + k0 + 8 + 2 * tq);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 v = unpack_bf16(af[e]);
              const float2 w = e < 2 ? w0 : w1;
              split2(v.x * w.x, v.y * w.y, ah_[e], al_[e]);
            }
            uint32_t xf[RP][4];
#pragma unroll
            for (int q = 0; q < RP; ++q)
              if (sub + WPM * q < PT)
                ldsm_x4_t(xf[q],
                          smem_u32(xc + (k0 + (i8 & 1) * 8 + r8) * LDW +
                                   (2 * (sub + WPM * q) + (i8 >> 1)) * 8));
#pragma unroll
            for (int q = 0; q < RP; ++q)
              if (sub + WPM * q < PT) {
                mma(ua[o][q][0], ah_, xf[q][0], xf[q][1]);
                mma(ua[o][q][1], ah_, xf[q][2], xf[q][3]);
              }
#pragma unroll
            for (int q = 0; q < RP; ++q)
              if (sub + WPM * q < PT) {
                mma(ua[o][q][0], al_, xf[q][0], xf[q][1]);
                mma(ua[o][q][1], al_, xf[q][2], xf[q][3]);
              }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RP; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[r][q][hh][e] = decay * st[r][q][hh][e] +
                              (ua[0][q][hh][e] + ua[1][q][hh][e]);
    }
  }
}

template <int NP, int W>
cudaError_t launch_tile(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, void* y, int batch,
                        int h, int g, int s, int L, int N, int P, int k,
                        cudaStream_t stream) {
  const size_t bytes = shared_bytes((L + 15) & ~15, NP, W);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<NP, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_kernel<NP, W><<<dim3(batch * h, k), THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<bf16*>(y), h, g, s, L, N, P,
      P / k);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_rows(int w, const void* x, const void* dt, const void* a,
                        const void* b, const void* c, void* y, int batch,
                        int h, int g, int s, int L, int N, int P, int k,
                        cudaStream_t st) {
  switch (w) {
    case 16:
      return launch_tile<NP, 16>(x, dt, a, b, c, y, batch, h, g, s, L, N, P,
                                 k, st);
    case 32:
      return launch_tile<NP, 32>(x, dt, a, b, c, y, batch, h, g, s, L, N, P,
                                 k, st);
    default:
      return launch_tile<NP, 64>(x, dt, a, b, c, y, batch, h, g, s, L, N, P,
                                 k, st);
  }
}

// Whether the kernel takes (N, P, k): rows of 16 bytes, k blocks of
// P / k columns each, a multiple of 8 and at most 64.
__host__ bool takes(int N, int P, int k) {
  return N > 0 && N % 8 == 0 && state_rows(N) > 0 && k > 0 && P % k == 0 &&
         (P / k) % 8 == 0 && tile_width(P / k) > 0;
}

cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, void* y, int batch, int h,
                   int g, int s, int L, int N, int P, int k,
                   cudaStream_t st) {
  if (!takes(N, P, k)) return cudaErrorInvalidValue;
  for (const void* p : {x, b, c, static_cast<const void*>(y)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const int w = tile_width(P / k);
  switch (state_rows(N)) {
    case 16:
      return launch_rows<16>(w, x, dt, a, b, c, y, batch, h, g, s, L, N, P,
                             k, st);
    case 32:
      return launch_rows<32>(w, x, dt, a, b, c, y, batch, h, g, s, L, N, P,
                             k, st);
    case 64:
      return launch_rows<64>(w, x, dt, a, b, c, y, batch, h, g, s, L, N, P,
                             k, st);
    case 128:
      return launch_rows<128>(w, x, dt, a, b, c, y, batch, h, g, s, L, N, P,
                              k, st);
    default:
      return launch_rows<256>(w, x, dt, a, b, c, y, batch, h, g, s, L, N, P,
                              k, st);
  }
}

}  // namespace tc

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory a block of the kernel for `dtype` (0 =
// float32, 1 = bfloat16) takes at chunk L, N, P and k blocks per (batch,
// head); -1 for a shape that kernel does not take.
long long ssd_scan_shared_bytes(int L, int N, int P, int k, int dtype) {
  if (dtype == 0)
    return fp32::takes(P, k)
               ? (long long)(sizeof(float) * fp32::shared_floats(L, N, P / k))
               : -1;
  if (!tc::takes(N, P, k)) return -1;
  return (long long)tc::shared_bytes((L + 15) & ~15, tc::state_rows(N),
                                     tc::tile_width(P / k));
}

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y alike; dt and a are
// float32); k: blocks per (batch, head).  Returns
// cudaGetLastError() after the launch as an int.
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* b, const void* c, void* y, int batch, int h,
                    int g, int s, int L, int N, int P, int k, int dtype,
                    void* stream) {
  (void)cudaGetLastError();  // clear any stale error before this launch
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        fp32::launch(x, dt, a, b, c, y, batch, h, g, s, L, N, P, k, st));
  return static_cast<int>(
      tc::launch(x, dt, a, b, c, y, batch, h, g, s, L, N, P, k, st));
}

}  // extern "C"
