// The NoC simulator's whole cycle loop as one CUDA kernel (sm_90a).
//
// Replaces: src/repro/kernels/noc_step.py:_noc_step_kernel (launched by
// run_fused there) in all three of its modes: statistical traffic with the
// per-kind diagnostics, trace replay (phase-gated injection, the phase
// barrier, strict barriers and the stall watchdog) and runtime fault
// injection (per-cycle drop masks on granted moves).  The math is that
// module's cycle_step; the plain PyTorch twin in
// src/repro_torch/kernels/noc_step.py repeats it and is this kernel's
// oracle.  Every accumulator is int32, so kernel, twin and reference agree
// bit for bit.
//
// What bounds it.  One cycle is a chain of dependent stages (route and
// score, then up to 23 re-arbitration passes of three stages each, then
// dequeue, then enqueue and injection), each a sweep over the L+1 queue
// rows or the n_phys+1 output channels that must finish before the next
// starts.  The bytes it must move are tiny (the streams and the route
// table, read once) and so are the operations; the time goes to the
// barrier-separated chain, cycles x stages long, and to the latency of the
// irregular gathers inside each stage.
//
// Design.  The TPU kernel ran grid=(cycles,) in order on one core with the
// state in VMEM.  Here one thread block runs one sweep point (grid =
// batch) and loops over the cycles itself, so the whole run is a single
// launch.  Block-stride loops cover the rows and channels, __syncthreads()
// separates the stages and __syncthreads_or() gives the fixpoint its early
// exit.  The queue state (packed words born<<11 | dst+1, lengths, aging
// counters) and the per-cycle temporaries live in a global-memory
// workspace that the wrapper allocates; at 1024 PEs they stay L2-resident.
// Per-cycle counts are warp-reduced and summed with shared-memory atomics,
// which are exact in any order.  Shared-memory residency, clusters, more
// than one block per point and CUDA graphs are later work.
//
// Modes.  Trace replay and faults are template flags of one kernel
// (noc_step_kernel<TRACE, FAULTS>, one host dispatch), so the statistical
// instantiation carries none of their code.  Faults: the [F] entries
// (queue, drop_p, onset) sit in shared memory; each cycle stage 1 marks the
// entries active this cycle (fault_u < drop_p in float32, cycle >= onset),
// and stage 3 drops a winner whose target queue an active entry names.
// Trace: the phase tables stay in global memory, ph_total and ph_done in
// shared memory, the per-PE sent counts in the workspace; thread 0 closes
// each cycle with the barrier update (post-add credit, cursor advance,
// watchdog), and a last block barrier publishes it before the next cycle.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Metric slots (kernels/noc_step.py).
constexpr int DELIVERED = 0, OFFERED = 1, ACCEPTED = 2, DROPPED = 3,
              LOST = 4, LAT_SUM = 5, MOVED = 6, STALL_CREDIT = 7,
              N_SCALARS = 8;
constexpr int N_KIND_ROWS = 3;
// Per-cycle counters in shared memory.
constexpr int C_DELIV = 0, C_OFFER = 1, C_ACC = 2, C_DROP_INJ = 3,
              C_DROP_ROUTE = 4, C_LOST_ENQ = 5, C_RESID = 6, C_LAT = 7,
              C_MOVED = 8, C_WINS = 9, C_STALLS = 17, C_FAULT = 25,
              N_CYC = 26;

// Workspace layout, in int32 words per point (`sent` is trace mode's
// per-PE count of flits injected in the current phase).
struct Work {
  int32_t *q_pack, *q_len, *wait, *head, *nxt, *score, *active, *win,
      *feas, *send, *best, *sent;
};

__host__ __device__ inline long long work_words(int L1, int NP1, int depth,
                                                int P) {
  return (long long)L1 * depth + 10LL * L1 + NP1 + P;
}

__device__ inline Work carve(int32_t* base, int L1, int NP1, int depth) {
  Work w;
  w.q_pack = base;
  w.q_len = w.q_pack + (size_t)L1 * depth;
  w.wait = w.q_len + L1;
  w.head = w.wait + L1;
  w.nxt = w.head + L1;
  w.score = w.nxt + L1;
  w.active = w.score + L1;
  w.win = w.active + L1;
  w.feas = w.win + L1;
  w.send = w.feas + L1;
  w.best = w.send + L1;
  w.sent = w.best + NP1;
  return w;
}

__device__ inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Warp-sum then one shared atomic per warp.  Every thread of the block
// calls it (after its block-stride loop), so the full mask is right.
__device__ inline void block_add(int* slot, int v) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(slot, v);
}

struct Params {
  const uint8_t* inj;     // [B, cycles, P] bool
  const int16_t* dst;     // [B, cycles, P]
  const int16_t* route;   // [L1, P]
  const int32_t* kind;    // [L1]
  const int32_t* prio;    // [L1]
  const int32_t* cap;     // [L1]
  const int32_t* phys;    // [L1] (dummy row -> n_phys)
  const uint8_t* is_sink; // [L1] bool
  const int32_t* inj_pe;  // [L1] PE injecting into this row, or -1
  const int32_t* cand;    // [NP1, Fc] queue ids (pad = L)
  const int32_t* intab;   // [L1, Fi] queue ids (pad = L)
  int32_t* work;          // [B, work_words]
  int32_t* q_len_out;     // [B, L1]
  int32_t* m_scal_out;    // [B, 8]
  int32_t* m_kind_out;    // [B, 3, 8]
  int32_t* passes_out;    // [B] arbitration passes run
  // Trace replay (TRACE): per-point phase tables and completion cycles.
  const int32_t* ph_dst;    // [B, n_phases, P]
  const int32_t* ph_flits;  // [B, n_phases, P]
  const int32_t* ph_total;  // [B, n_phases]
  int32_t* ph_done_out;     // [B, n_phases]
  // Fault injection (FAULTS): per-point entries and the uniform stream.
  const float* fault_u;     // [B, cycles, F]
  const int32_t* f_links;   // [B, F] queue ids (pad = L)
  const float* f_drop;      // [B, F] (pad = 0)
  const int32_t* f_onset;   // [B, F]
  int L1, P, NP1, Fc, Fi, depth, cycles, warmup, starv, arb_iters,
      diagnostics, pow2, n_phases, strict_barrier, watchdog, F;
};

// One select + feasibility pass of the grant/re-arbitrate fixpoint.
// Returns, to every thread, whether some winner is infeasible.
__device__ int arb_pass(const Params& p, const Work& w) {
  const int tid = threadIdx.x, nt = blockDim.x, L = p.L1 - 1;
  // Row-max over each output channel's structural candidates.
  for (int c = tid; c < p.NP1; c += nt) {
    int best = -1;
    const int32_t* row = p.cand + (size_t)c * p.Fc;
    for (int j = 0; j < p.Fc; ++j) {
      const int q = row[j];
      if (w.active[q] && p.phys[clampi(w.nxt[q], 0, L)] == c) {
        const int s = w.score[q];
        best = s > best ? s : best;
      }
    }
    w.best[c] = best;
  }
  __syncthreads();
  for (int r = tid; r < p.L1; r += nt) {
    const int nc = clampi(w.nxt[r], 0, L);
    w.win[r] = w.active[r] && w.score[r] == w.best[p.phys[nc]];
  }
  __syncthreads();
  int bad = 0;
  for (int r = tid; r < p.L1; r += nt) {
    const int nc = clampi(w.nxt[r], 0, L);
    // A grant into a full queue is feasible only if that queue's own head
    // departs this cycle.  q_len is still the pre-move length here.
    const int f = (w.q_len[nc] - w.win[nc]) < p.cap[nc];
    w.feas[r] = f;
    bad |= w.win[r] && !f;
  }
  return __syncthreads_or(bad);
}

template <bool TRACE, bool FAULTS>
__global__ void __launch_bounds__(1024, 1) noc_step_kernel(Params p) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int L1 = p.L1, L = L1 - 1, P = p.P, D = p.depth;
  const Work w = carve(p.work + (size_t)b * work_words(L1, p.NP1, D, P), L1,
                       p.NP1, D);
  const uint8_t* inj = p.inj + (size_t)b * p.cycles * P;
  const int16_t* dst = p.dst + (size_t)b * p.cycles * P;

  __shared__ int cyc[N_CYC];
  __shared__ int m_scal[N_SCALARS];
  __shared__ int m_kind[2 * 8];
  // Dynamic shared memory: fault mode's [F] entries and per-cycle active
  // flags, then trace mode's ph_total and ph_done [n_phases].
  extern __shared__ int dyn[];
  int* f_links = dyn;
  float* f_drop = reinterpret_cast<float*>(dyn + p.F);
  int* f_onset = dyn + 2 * p.F;
  int* f_act = dyn + 3 * p.F;
  int* ph_total = dyn + 4 * p.F;
  int* ph_done = ph_total + p.n_phases;
  // Trace barrier state (thread 0 writes it at the end of a cycle).
  __shared__ int s_cur, s_credit, s_stall, s_done_now;
  const int NPH = p.n_phases;
  const int32_t* ph_dst = p.ph_dst + (size_t)b * NPH * P;
  const int32_t* ph_flits = p.ph_flits + (size_t)b * NPH * P;
  const float* fault_u = p.fault_u + (size_t)b * p.cycles * p.F;

  for (int i = tid; i < L1 * D; i += nt) w.q_pack[i] = 0;
  for (int r = tid; r < L1; r += nt) {
    w.q_len[r] = 0;
    w.wait[r] = 0;
  }
  if (tid < N_CYC) cyc[tid] = 0;
  if (tid < N_SCALARS) m_scal[tid] = 0;
  if (tid < 16) m_kind[tid] = 0;
  if constexpr (FAULTS) {
    for (int f = tid; f < p.F; f += nt) {
      f_links[f] = p.f_links[(size_t)b * p.F + f];
      f_drop[f] = p.f_drop[(size_t)b * p.F + f];
      f_onset[f] = p.f_onset[(size_t)b * p.F + f];
    }
  }
  if constexpr (TRACE) {
    for (int i = tid; i < P; i += nt) w.sent[i] = 0;
    for (int i = tid; i < NPH; i += nt) {
      ph_total[i] = p.ph_total[(size_t)b * NPH + i];
      ph_done[i] = -1;
    }
    if (tid == 0) {
      s_cur = 0;
      s_credit = 0;
      s_stall = 0;
      s_done_now = 0;
    }
  }
  int passes = 0;  // meaningful in thread 0
  __syncthreads();

  for (int cycle = 0; cycle < p.cycles; ++cycle) {
    // --- 1. routing and arbitration scores (+ this cycle's fault flags) -
    if constexpr (FAULTS) {
      for (int f = tid; f < p.F; f += nt)
        f_act[f] = fault_u[(size_t)cycle * p.F + f] < f_drop[f] &&
                   cycle >= f_onset[f];
    }
    for (int r = tid; r < L1; r += nt) {
      const int hp = w.q_pack[(size_t)r * D];
      w.head[r] = hp;  // pre-move head: enqueue reads it after the shift
      const bool valid = w.q_len[r] > 0;
      const int hd = clampi((hp & 2047) - 1, 0, P - 1);
      const int nx = valid ? (int)p.route[(size_t)r * P + hd] : -1;
      w.nxt[r] = nx;
      w.active[r] = valid && nx >= 0;
      const int wt = w.wait[r];
      const int eff = p.prio[r] * 2 + (wt < p.starv ? wt : p.starv);
      w.score[r] = eff * p.pow2 + ((r + cycle) & (p.pow2 - 1));
    }
    __syncthreads();

    // --- 2. grant / re-arbitrate fixpoint, counter from 1 ---------------
    int it = 1;
    int bad = arb_pass(p, w);
    while (bad && it < p.arb_iters) {
      for (int r = tid; r < L1; r += nt)
        w.active[r] = w.active[r] && (!w.win[r] || w.feas[r]);
      __syncthreads();
      bad = arb_pass(p, w);
      ++it;
    }
    passes += it;

    // --- 3. dequeue, deliveries, aging, fault drops ----------------------
    int deliv = 0, lat = 0, moved = 0, resid = 0, droute = 0, fdrop = 0;
    for (int r = tid; r < L1; r += nt) {
      const int ql = w.q_len[r];
      const bool valid = ql > 0;
      const int nx = w.nxt[r];
      const int nc = clampi(nx, 0, L);
      const bool won = w.win[r], f = w.feas[r];
      const bool winner = won && f;
      const bool drop_route = valid && nx < 0;
      const bool deq = winner || drop_route;
      const bool sink = p.is_sink[nc];
      // A winner whose wire is faulty this cycle leaves its queue (and
      // counts as moved) but never arrives.
      bool lost_on_wire = false;
      if constexpr (FAULTS) {
        if (winner)
          for (int k = 0; k < p.F; ++k)
            lost_on_wire |= f_act[k] && f_links[k] == nc;
      }
      w.send[r] = winner && !sink && !lost_on_wire;
      if (winner && sink && !lost_on_wire) {
        ++deliv;
        lat += cycle - (w.head[r] >> 11);
      }
      moved += winner;
      resid += won && !f;
      droute += drop_route;
      fdrop += lost_on_wire;
      w.wait[r] = (valid && !deq) ? w.wait[r] + 1 : 0;
      if (deq) {
        int32_t* q = w.q_pack + (size_t)r * D;
        for (int k = 0; k + 1 < D; ++k) q[k] = q[k + 1];
        q[D - 1] = 0;
        w.q_len[r] = ql - 1;
      }
      if (p.diagnostics) {
        const unsigned kw = p.kind[r], ks = p.kind[nc];
        if (winner && kw < 8) atomicAdd(&cyc[C_WINS + kw], 1);
        if (valid && nx >= 0 && !winner && ks < 8)
          atomicAdd(&cyc[C_STALLS + ks], 1);
      }
    }
    block_add(&cyc[C_DELIV], deliv);
    block_add(&cyc[C_LAT], lat);
    block_add(&cyc[C_MOVED], moved);
    block_add(&cyc[C_RESID], resid);
    block_add(&cyc[C_DROP_ROUTE], droute);
    if constexpr (FAULTS) block_add(&cyc[C_FAULT], fdrop);
    __syncthreads();

    // --- 4. enqueue through the fan-in table, then injection -------------
    // Nothing routes into an inject queue, and each PE's inject queue is
    // the one row whose inj_pe names it, so every row is written by its
    // own thread only, from post-dequeue lengths.  In trace mode the same
    // thread owns its PE's `sent` count.
    int cur = 0;
    bool phase_active = false;
    if constexpr (TRACE) {
      phase_active = s_cur < NPH;  // the unclipped cursor
      cur = clampi(s_cur, 0, NPH - 1);
    }
    int offer = 0, accd = 0, dinj = 0, lost = 0;
    for (int r = tid; r < L1; r += nt) {
      int src = -1;
      const int32_t* row = p.intab + (size_t)r * p.Fi;
      for (int j = 0; j < p.Fi; ++j) {
        const int q = row[j];
        if (w.send[q] && clampi(w.nxt[q], 0, L) == r) src = q > src ? q : src;
      }
      const int ql = w.q_len[r];
      const int cap = p.cap[r];
      const bool has_in = src >= 0;
      const bool lost_row = has_in && ql >= cap;
      const bool enq = has_in && !lost_row;
      lost += lost_row;
      const int pe = p.inj_pe[r];
      bool acc = false;
      int dst_pe = 0;
      if (pe >= 0) {
        bool want = inj[(size_t)cycle * P + pe];
        const bool room = ql < cap;
        if constexpr (TRACE) {
          const size_t at = (size_t)cur * P + pe;
          want = want && phase_active && ph_flits[at] - w.sent[pe] > 0;
          dst_pe = ph_dst[at];
          acc = want && room;
          w.sent[pe] += acc;
        } else {
          dst_pe = dst[(size_t)cycle * P + pe];
          acc = want && room;
          offer += want;
          dinj += want && !room;
        }
        accd += acc;
      }
      if (enq || acc) {
        const int val = enq ? w.head[clampi(src, 0, L)]
                            : ((cycle << 11) | (dst_pe + 1));
        w.q_pack[(size_t)r * D + clampi(ql, 0, D - 1)] = val;
        w.q_len[r] = ql + 1;
      }
    }
    block_add(&cyc[C_OFFER], offer);
    block_add(&cyc[C_ACC], accd);
    block_add(&cyc[C_DROP_INJ], dinj);
    block_add(&cyc[C_LOST_ENQ], lost);
    __syncthreads();

    // --- 5. metric accumulation (warmup-gated; `lost` ungated) ----------
    // Trace mode: offered := accepted and a refused injection is not a
    // drop (it retries next cycle).
    if (tid == 0) {
      const int g = cycle >= p.warmup;
      const int hard = cyc[C_DROP_ROUTE] + cyc[C_LOST_ENQ] +
                       (FAULTS ? cyc[C_FAULT] : 0);
      m_scal[DELIVERED] += g * cyc[C_DELIV];
      m_scal[OFFERED] += g * (TRACE ? cyc[C_ACC] : cyc[C_OFFER]);
      m_scal[ACCEPTED] += g * cyc[C_ACC];
      m_scal[DROPPED] += g * (hard + (TRACE ? 0 : cyc[C_DROP_INJ]));
      m_scal[LOST] += cyc[C_LOST_ENQ] + cyc[C_RESID];
      m_scal[LAT_SUM] += g * cyc[C_LAT];
      m_scal[MOVED] += g * cyc[C_MOVED];
      for (int k = 0; k < 16; ++k) m_kind[k] += g * cyc[C_WINS + k];
      if constexpr (TRACE) {
        // --- 6. phase barrier, on the cycle's closed counts -------------
        const int retired =
            p.strict_barrier ? cyc[C_DELIV] : cyc[C_DELIV] + hard;
        const int credit = s_credit + retired;
        const int total = ph_total[cur];
        const bool done_now = phase_active && credit >= total;
        if (done_now) ph_done[cur] = cycle;
        s_cur += done_now;
        s_credit = done_now ? 0 : credit;
        s_done_now = done_now;
        if (p.watchdog) {
          const bool progress =
              retired > 0 || cyc[C_ACC] > 0 || cyc[C_MOVED] > 0;
          s_stall = (phase_active && !done_now && !progress) ? s_stall + 1
                                                             : 0;
          if (phase_active && !done_now && s_stall >= p.watchdog) {
            ph_done[cur] = -2 - cycle;
            m_scal[STALL_CREDIT] += total - s_credit;
            s_cur = NPH;
          }
        }
      }
      for (int k = 0; k < N_CYC; ++k) cyc[k] = 0;
    }
    if constexpr (TRACE) {
      // Publish the cursor; a finished phase's sent counts restart at 0.
      __syncthreads();
      if (s_done_now)
        for (int i = tid; i < P; i += nt) w.sent[i] = 0;
    }
    // The next writes to cyc[] come after stage 1's barrier.
  }
  __syncthreads();

  for (int r = tid; r < L1; r += nt) p.q_len_out[(size_t)b * L1 + r] = w.q_len[r];
  if (tid < N_SCALARS) p.m_scal_out[b * N_SCALARS + tid] = m_scal[tid];
  if (tid < N_KIND_ROWS * 8)
    p.m_kind_out[b * N_KIND_ROWS * 8 + tid] = tid < 16 ? m_kind[tid] : 0;
  if (tid == 0) p.passes_out[b] = passes;
  if constexpr (TRACE)
    for (int i = tid; i < NPH; i += nt)
      p.ph_done_out[(size_t)b * NPH + i] = ph_done[i];
}

}  // namespace

extern "C" {

long long noc_step_workspace_words(int L1, int NP1, int depth, int P) {
  return work_words(L1, NP1, depth, P);
}

const char* noc_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the kernel on `stream` (grid = batch, one block per point) in
// the mode its operands ask for: trace replay when n_phases > 0, fault
// injection when F > 0.  Returns cudaGetLastError() as an int (0 =
// launched).
int noc_step_launch(const void* inj, const void* dst, const void* route,
                    const void* kind, const void* prio, const void* cap,
                    const void* phys, const void* is_sink,
                    const void* pe_src_link, const void* inj_pe,
                    const void* cand, const void* intab, void* work,
                    void* q_len_out, void* m_scal_out, void* m_kind_out,
                    void* passes_out, const void* ph_dst,
                    const void* ph_flits, const void* ph_total,
                    void* ph_done_out, const void* fault_u,
                    const void* f_links, const void* f_drop,
                    const void* f_onset, int batch, int L1, int P, int NP1,
                    int Fc, int Fi, int depth, int cycles, int warmup,
                    int starv, int arb_iters, int diagnostics, int pow2,
                    int threads, int n_phases, int strict_barrier,
                    int watchdog, int F, void* stream) {
  (void)pe_src_link;  // implied by inj_pe (checked when geometry is built)
  Params p;
  p.inj = static_cast<const uint8_t*>(inj);
  p.dst = static_cast<const int16_t*>(dst);
  p.route = static_cast<const int16_t*>(route);
  p.kind = static_cast<const int32_t*>(kind);
  p.prio = static_cast<const int32_t*>(prio);
  p.cap = static_cast<const int32_t*>(cap);
  p.phys = static_cast<const int32_t*>(phys);
  p.is_sink = static_cast<const uint8_t*>(is_sink);
  p.inj_pe = static_cast<const int32_t*>(inj_pe);
  p.cand = static_cast<const int32_t*>(cand);
  p.intab = static_cast<const int32_t*>(intab);
  p.work = static_cast<int32_t*>(work);
  p.q_len_out = static_cast<int32_t*>(q_len_out);
  p.m_scal_out = static_cast<int32_t*>(m_scal_out);
  p.m_kind_out = static_cast<int32_t*>(m_kind_out);
  p.passes_out = static_cast<int32_t*>(passes_out);
  p.ph_dst = static_cast<const int32_t*>(ph_dst);
  p.ph_flits = static_cast<const int32_t*>(ph_flits);
  p.ph_total = static_cast<const int32_t*>(ph_total);
  p.ph_done_out = static_cast<int32_t*>(ph_done_out);
  p.fault_u = static_cast<const float*>(fault_u);
  p.f_links = static_cast<const int32_t*>(f_links);
  p.f_drop = static_cast<const float*>(f_drop);
  p.f_onset = static_cast<const int32_t*>(f_onset);
  p.L1 = L1;
  p.P = P;
  p.NP1 = NP1;
  p.Fc = Fc;
  p.Fi = Fi;
  p.depth = depth;
  p.cycles = cycles;
  p.warmup = warmup;
  p.starv = starv;
  p.arb_iters = arb_iters;
  p.diagnostics = diagnostics;
  p.pow2 = pow2;
  p.n_phases = n_phases;
  p.strict_barrier = strict_barrier;
  p.watchdog = watchdog;
  p.F = F;
  const size_t shared = sizeof(int) * (4 * (size_t)F + 2 * (size_t)n_phases);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();  // clear any stale error before this launch
  if (n_phases > 0 && F > 0)
    noc_step_kernel<true, true><<<batch, threads, shared, s>>>(p);
  else if (n_phases > 0)
    noc_step_kernel<true, false><<<batch, threads, shared, s>>>(p);
  else if (F > 0)
    noc_step_kernel<false, true><<<batch, threads, shared, s>>>(p);
  else
    noc_step_kernel<false, false><<<batch, threads, shared, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
