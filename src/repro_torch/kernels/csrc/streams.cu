// The NoC simulator's random streams for a whole batch of points, in one
// CUDA launch (sm_90a).
//
// Replaces no Pallas kernel: the reference draws these streams with
// jax.random inside _run_core (src/repro/core/sim.py), which XLA fuses.
// The port's plain version is core/sim.py _draw_streams_plain over
// core/prng.py, which holds each uint32 word in an int64 tensor and so
// takes ~170 elementwise launches a Threefry call, 12 calls a point.  This
// kernel computes the same bits (prng.py's docstring sets the arithmetic
// out) in native uint32 and writes what draw_streams returns:
//
//   inj [B, cycles, P] bool     bernoulli(k_inj, inj_rate)
//   dst [B, cycles, P] int16    the locality select over randint offsets
//   fault_u [B, cycles, F] f32  uniform(k_flt), when F > 0
//
// What bounds it.  Instruction rate: 8 Threefry-2x32 hashes an element of
// a uniform point (injection 1, the randint offset 2, the locality uniform
// 1, ringlet 2, block 2), 6 of a permutation point (no offset), each at
// least 60 instructions (20 rounds of an add, a funnel shift and a xor),
// against 3 bytes written.  The paper's grid (1024 PEs x 1500 cycles, 4
// uniform and 8 permutation points) takes at least 7.4 G thread instructions:
// ~0.22 ms at the H100's 132 SMs x 4 schedulers x 32 lanes a clock at
// 1.98 GHz, where its 55 MB take ~0.02 ms at 3.35 TB/s.
//
// Design.  grid = (element tiles + fault tiles, B): blockIdx.y is the
// point, so its key, rates and permutation flag are uniform across the
// block.  Each block first derives the point's 9 subkeys (the 5- or 6-way
// split of (0, seed), then the 2-way split of each randint key) in two
// rounds of a few threads into shared memory: 12 hashes against the block's
// 8 192.  Each thread then takes 4 consecutive elements of the point's
// row-major [cycles, P] stream (one counter each, the flat index as a
// 64-bit (high, low) pair) and stores them as one 32-bit word of bools and
// one 64-bit word of int16 where the stream length divides by 4; a ragged
// tail stores element by element.  The blocks past the element tiles draw
// the fault uniforms, 4 a thread.  The offset hash is skipped on a
// permutation point (no output reads it); the ringlet and block hashes are
// computed for every element, since neighbouring PEs take different
// branches of the select and a divergent warp runs both anyway.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
// core/packet.py: PES_PER_RINGLET and PES_PER_BLOCK (the launcher refuses
// others), so the ringlet and block draws fold by constant spans.
constexpr int kRinglet = 4;
constexpr int kBlock = 16;
// Words of a point's row of the table before its permutation
// (kernels/streams.py, HEADER).
enum { kSeed, kInjRate, kLocRing, kLocBoth, kUsePerm, kHeader };
// Subkeys in shared memory: the top-level split, then the randint halves.
enum { kInj, kDst, kLoc, kRing, kBlk, kFlt, kDstHi, kDstLo, kRingHi,
       kRingLo, kBlkHi, kBlkLo, kKeys };

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// Threefry-2x32, 20 rounds, of the counter (x0, x1) under the key (k0, k1).
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// random_bits: the two output words of the element's counter, XORed.
__device__ __forceinline__ uint32_t bits(uint2 k, uint32_t hi,
                                         uint32_t lo) {
  const uint2 b = threefry(k.x, k.y, hi, lo);
  return b.x ^ b.y;
}

// uniform: the top 23 bits as a mantissa in [1, 2), less 1.
__device__ __forceinline__ float uniform(uint32_t b) {
  return __int_as_float(static_cast<int>((b >> 9) | 0x3F800000u)) - 1.0f;
}

// randint's fold of two draws into [0, span), in uint32 with wrap-around:
// the high draw weighs 2^32 % span, taken as ((2^16 % span)^2) % span.
__device__ __forceinline__ uint32_t fold(uint32_t higher, uint32_t lower,
                                         uint32_t span) {
  const uint32_t half = 65536u % span;
  return ((higher % span) * (half * half % span) + lower % span) % span;
}

__global__ void __launch_bounds__(kThreads)
streams_kernel(const int32_t* __restrict__ table, uint8_t* __restrict__ inj,
               int16_t* __restrict__ dst, float* __restrict__ fault_u,
               int cycles, int P, int F, int elem_tiles, int vec) {
  __shared__ uint2 keys[kKeys];
  const int b = blockIdx.y;
  const int32_t* row = table + static_cast<long long>(b) * (kHeader + P);
  const int t = threadIdx.x;
  // The point's key (0, seed) split 5 ways, or 6 with fault draws; then
  // each randint key split 2 ways.
  const int n_split = F > 0 ? 6 : 5;
  if (t < n_split) {
    const uint2 k = threefry(0u, static_cast<uint32_t>(row[kSeed]), 0u,
                             static_cast<uint32_t>(t));
    keys[t] = k;
  }
  __syncthreads();
  if (t < 6) {
    const int parent = t < 2 ? kDst : (t < 4 ? kRing : kBlk);
    keys[kDstHi + t] = threefry(keys[parent].x, keys[parent].y, 0u,
                                static_cast<uint32_t>(t & 1));
  }
  __syncthreads();

  if (static_cast<int>(blockIdx.x) >= elem_tiles) {  // fault draws
    const long long n = static_cast<long long>(cycles) * F;
    const long long j0 =
        (static_cast<long long>(blockIdx.x - elem_tiles) * kThreads + t) *
        kPerThread;
    const uint2 k = keys[kFlt];
    float* out = fault_u + static_cast<long long>(b) * n;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const long long j = j0 + i;
      if (j < n)
        out[j] = uniform(bits(k, static_cast<uint32_t>(j >> 32),
                              static_cast<uint32_t>(j)));
    }
    return;
  }

  const long long n = static_cast<long long>(cycles) * P;
  const long long j0 =
      (static_cast<long long>(blockIdx.x) * kThreads + t) * kPerThread;
  if (j0 >= n) return;
  const float inj_rate = __int_as_float(row[kInjRate]);
  const float loc_ring = __int_as_float(row[kLocRing]);
  const float loc_both = __int_as_float(row[kLocBoth]);
  const bool use_perm = row[kUsePerm] != 0;
  const uint32_t span_dst = P > 1 ? static_cast<uint32_t>(P - 1) : 1u;
  const int32_t* perm = row + kHeader;
  const uint2 k_inj = keys[kInj], k_loc = keys[kLoc];
  const uint2 k_dhi = keys[kDstHi], k_dlo = keys[kDstLo];
  const uint2 k_rhi = keys[kRingHi], k_rlo = keys[kRingLo];
  const uint2 k_bhi = keys[kBlkHi], k_blo = keys[kBlkLo];

  uint8_t inj_v[kPerThread];
  int16_t dst_v[kPerThread];
  int p = static_cast<int>(j0 % P);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = j0 + i;
    inj_v[i] = 0;
    dst_v[i] = 0;
    if (j < n) {
      const uint32_t hi = static_cast<uint32_t>(j >> 32);
      const uint32_t lo = static_cast<uint32_t>(j);
      inj_v[i] = uniform(bits(k_inj, hi, lo)) < inj_rate;
      int base;
      if (use_perm) {
        base = perm[p];
      } else {
        const int off = static_cast<int>(fold(bits(k_dhi, hi, lo),
                                              bits(k_dlo, hi, lo),
                                              span_dst)) + 1;
        base = p + off >= P ? p + off - P : p + off;  // p + off < 2P
      }
      const float u = uniform(bits(k_loc, hi, lo));
      const int ring = static_cast<int>(fold(bits(k_rhi, hi, lo),
                                             bits(k_rlo, hi, lo),
                                             kRinglet - 1)) + 1;
      const int blk = static_cast<int>(fold(bits(k_bhi, hi, lo),
                                            bits(k_blo, hi, lo),
                                            kBlock - 1)) + 1;
      const int ring_peer =
          p - p % kRinglet + (p % kRinglet + ring) % kRinglet;
      const int blk_peer = p - p % kBlock + (p % kBlock + blk) % kBlock;
      dst_v[i] = static_cast<int16_t>(
          u < loc_ring ? ring_peer : (u < loc_both ? blk_peer : base));
    }
    p = p + 1 == P ? 0 : p + 1;
  }
  const long long at = static_cast<long long>(b) * n + j0;
  if (vec && j0 + kPerThread <= n) {
    uint32_t w = 0;
    uint2 d;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) w |= uint32_t(inj_v[i]) << (8 * i);
    d.x = uint32_t(uint16_t(dst_v[0])) | (uint32_t(uint16_t(dst_v[1])) << 16);
    d.y = uint32_t(uint16_t(dst_v[2])) | (uint32_t(uint16_t(dst_v[3])) << 16);
    *reinterpret_cast<uint32_t*>(inj + at) = w;
    *reinterpret_cast<uint2*>(dst + at) = d;
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (j0 + i < n) {
        inj[at + i] = inj_v[i];
        dst[at + i] = dst_v[i];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* streams_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the kernel on `stream` for `batch` points: `table` is the
// [batch, HEADER + P] int32 point table (kernels/streams.py point_table),
// the outputs [batch, cycles, P] (inj, dst) and [batch, cycles, F]
// (fault_u, null when F == 0).  `ringlet` and `block` are the packet
// constants the caller draws with; the kernel folds by its own, so others
// are refused.  Returns cudaGetLastError() as an int (0 = launched).
int streams_launch(const void* table, void* inj, void* dst, void* fault_u,
                   int batch, int cycles, int P, int F, int ringlet,
                   int block, void* stream) {
  if (ringlet != kRinglet || block != kBlock || batch < 1 ||
      batch > 65535 || cycles < 1 || P < 1 || F < 0 ||
      (F > 0 && fault_u == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(cycles) * P;
  const long long elem_tiles = (n + kTile - 1) / kTile;
  const long long fault_tiles =
      (static_cast<long long>(cycles) * F + kTile - 1) / kTile;
  if (elem_tiles + fault_tiles > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // Whole-word stores need every thread's 4 elements at a 4-element
  // boundary of the batch's buffers.
  const int vec = n % kPerThread == 0 &&
                  reinterpret_cast<uintptr_t>(inj) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(dst) % 8 == 0;
  (void)cudaGetLastError();  // clear any stale error before this launch
  streams_kernel<<<dim3(static_cast<unsigned>(elem_tiles + fault_tiles),
                        batch),
                   kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<uint8_t*>(inj),
      static_cast<int16_t*>(dst), static_cast<float*>(fault_u), cycles, P,
      F, static_cast<int>(elem_tiles), vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
