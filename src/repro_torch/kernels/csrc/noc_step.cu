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
// score, then up to 24 arbitration passes, then dequeue, then enqueue and
// injection), each a sweep over the L+1 queue rows that must finish, on
// every CTA of the point, before the next starts.  The bytes it must move
// are tiny (the streams and the route table, read once) and so are the
// operations; the time goes to the barriers between the stages (a block
// barrier costs ~48 ns on the H100, a cluster barrier ~710 ns with 1 024
// threads per CTA: chip_smoke.py phase 1), to the latency of the
// irregular reads inside each stage and, across a cluster, to the rate of
// requests into other CTAs' shared memory.
//
// Design.  The TPU kernel ran grid=(cycles,) in order on one core with the
// state in VMEM.  Here one thread-block cluster of C CTAs (1 <= C <= 8,
// 1 024 threads each) runs one sweep point and loops over the cycles
// itself, so the whole run is a single launch.  CTA `rank` owns the queue
// rows [rank*R, rank*R + R) and the output channels [rank*RC, rank*RC +
// RC) and keeps all their state in its shared memory, narrowed where that
// is exact: q_len and cap in a byte (capacity <= 8; the unbounded ejection
// queues never hold a flit), wait in 16 bits saturated at the starvation
// limit (only min(wait, starv) is ever read), nxt, phys and prio in 16
// bits, active/win/feas as bits of one byte; each queue is a ring of
// packed words, so a dequeue moves its head index and no words.  Only the
// route table and the streams stay in global memory (read once per row
// and cycle, together, in stage 1).  A row of another CTA is read, or
// raised with an atomic, through distributed shared memory
// (map_shared_rank), whose request rate bounds a pass at C > 1; there the
// host orders rows and channels by fabric node (kernels/noc_step.py,
// `locality_order`), so a row's target channel is its own CTA's and only
// hops that leave the CTA's patch of the fabric cross (8-21 % at 1024
// PEs, `remote_share`).  Ids stay the geometry's where the reference's
// semantics read them (the score's rotation, the largest sender wins).
// The host picks the smallest C whose slice fits 227 KB (`cluster_plan`):
// C = 1 at 64 and 256 PEs, where every barrier is a block barrier, and
// C = 3-4 at 1024 PEs, where a barrier after which a CTA reads another's
// rows is a cluster barrier (barrier.cluster arrive/wait).
//
// Fewer, cheaper stages.  The reference gathers each channel's row-max
// and each row's incoming sender over the structural fan-in tables
// (cand, intab); since every route hop is node-local and those tables
// list every queue arriving at a node, the kernel scatters instead
// (atomicMax from each contending row into its target channel's maximum,
// and from each sender into its target row), which touches only the
// active rows; they are listed once per cycle.  A pass computes its rows'
// wins and feasibility in one stage (a row reads the inputs of its target
// queue's win itself) and raises the next pass's maxima at once, so a
// re-arbitration costs one barrier, not four; the maxima take three slots
// and the flags two, by pass, so no slot is cleared, raised and read
// without a barrier between.  A cycle costs a cluster barrier per pass,
// one before the first pass and one after dequeue, and two block barriers
// (after stage 1 and at its end: stage 1 touches only the CTA's own rows,
// and the pre-move heads take two slots by cycle).  The
// fixpoint's early exit is a cluster-wide OR: a warp that finds an
// infeasible winner writes a flag into every CTA (three slots by pass),
// and each CTA reads its own after the pass's barrier.  Per-cycle
// counters are summed per CTA (warp sums, shared atomics, two slots by
// cycle) into per-CTA metric partials that rank 0 adds up at the end.
//
// Modes.  Trace replay, its records form, faults and the cluster are
// template flags of one kernel (noc_step_kernel<TRACE, REC, FAULTS, CL>,
// one host dispatch), so the statistical instantiation carries none of the
// others' code, a one-record trace none of the record walk's (whose extra
// live values made the trace mode spill more) and C == 1 none of the
// cluster's.  Faults: the [F] entries (queue, drop_p, onset)
// are copied into every CTA; each cycle stage 1 marks the entries active
// this cycle (fault_u < drop_p in float32, cycle >= onset), and stage 3
// drops a winner whose target queue an active entry names.  Trace: the
// phase tables stay in global memory, ph_total and ph_done in rank 0's
// shared memory, the per-PE sent counts in the shared memory of the CTA
// that owns the PE's inject row; the cycle ends in a cluster barrier, after
// which rank 0 adds every rank's counts and runs the phase barrier update,
// and the others read its cursor in the next cycle's stage 4.  In records
// form (REC, a source sending several records a phase) the phase tables
// give each source's phase total, and the record tables (each source's
// first record of a phase, every record's destination and running end)
// stay in global memory; each PE's record cursor sits after the sent
// counts, steps on when the PE's count reaches the record's end, and moves
// to the PE's first record of the next phase when the count restarts.
//
// Counters.  Given a `clock_out` buffer, the host launches the mode's
// twin with its counters on (noc_step_clocked: the same body with CLOCK
// set): thread 0 of each CTA adds up the clock64() cycles it spends inside
// each barrier of the cycle loop and times the whole loop, in two int64
// words of the control block, and writes both at the end: the share of
// the loop a CTA waits at barriers.  Off (a null pointer), noc_step_kernel
// runs the body without them, so the counters cost it nothing.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// Metric slots (kernels/noc_step.py).
constexpr int DELIVERED = 0, OFFERED = 1, ACCEPTED = 2, DROPPED = 3,
              LOST = 4, LAT_SUM = 5, MOVED = 6, STALL_CREDIT = 7,
              N_SCALARS = 8;
constexpr int N_KIND_ROWS = 3;
// Per-cycle counters.
constexpr int C_DELIV = 0, C_OFFER = 1, C_ACC = 2, C_DROP_INJ = 3,
              C_DROP_ROUTE = 4, C_LOST_ENQ = 5, C_RESID = 6, C_LAT = 7,
              C_MOVED = 8, C_WINS = 9, C_STALLS = 17, C_FAULT = 25,
              N_CYC = 26;
// The control block: per-cycle counters (two slots by cycle parity), the
// CTA's metric partials, the fixpoint flags (three slots by pass),
// rank 0's trace barrier state, the length of the active-row list, and
// two int64 clocks (SM cycles waited at the cycle loop's barriers, and of
// the whole loop) kept by thread 0 while the counters are on.  Words;
// kernels/noc_step.py mirrors the count (CTL_WORDS).
constexpr int K_CYC = 0, K_SCAL = 2 * N_CYC, K_KIND = K_SCAL + N_SCALARS,
              K_BAD = K_KIND + 16, K_CUR = K_BAD + 3, K_CREDIT = K_CUR + 1,
              K_STALL = K_CUR + 2, K_DONE = K_CUR + 3, K_NACT = K_CUR + 4,
              K_WAITED = K_NACT + 1, K_LOOP = K_WAITED + 2, CTL_WORDS = 88;
static_assert(K_LOOP + 2 <= CTL_WORDS, "control block overflow");
static_assert(K_WAITED % 2 == 0, "the int64 clocks need 8-byte alignment");

// One CTA's shared memory.  `carve` lays it out, 16-byte aligned arrays in
// this order; kernels/noc_step.py:shared_bytes repeats the arithmetic.
// Each row's queue is a ring of `depth` packed words starting at q_head.
// head has two slots by cycle parity, best three by pass, flags two by
// pass parity.  inj_v / dst_v hold the row's PE's injection and
// destination of the cycle, read from the streams in stage 1.  score_nc, nphys_nc and room_nc cache, for an active row,
// what the fixpoint reads of the queue its head targets and that holds
// still through it (its score, its target channel, its free slots).
struct Smem {
  // int32
  int32_t *q_pack, *head, *score, *src_of, *score_nc, *best, *sent, *f_links;
  float* f_drop;
  int32_t *f_onset, *f_act, *ph_total, *ph_done, *ctl;
  // 16-bit
  int16_t *nxt, *nphys;
  uint16_t* wait;
  int16_t *phys, *prio, *inj_pe, *act, *nphys_nc, *dst_v, *orig;
  // bytes
  uint8_t *q_len, *flags, *cap, *stat, *room_nc, *q_head, *inj_v;
};

// Bits of a row's `flags` byte (written only by the row's own thread).
constexpr uint8_t F_ACTIVE = 1, F_WIN = 2, F_FEAS = 4;
// A row's static `stat` byte: its kind in the low four bits (NO_KIND when
// outside [0, 8), never counted), is_sink, and whether the row is one of
// the structural candidates (`cand`) at all: a queue that is in no bucket
// (a dead queue of a repaired fabric) never contends.
constexpr int NO_KIND = 15, S_SINK = 16, S_CONTENDS = 32;

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t start = at;
  at += (bytes + 15) / 16 * 16;
  return start;
}

// Lays out a CTA's slice (R rows, RC channels) at `base` (device) or only
// sizes it (base == nullptr).  Returns the bytes.
__host__ __device__ inline size_t carve(Smem* s, unsigned char* base, int R,
                                        int RC, int depth, int P, int F,
                                        int n_phases, int records) {
  size_t at = 0;
  size_t o[32];
  int n = 0;
  o[n++] = take(at, 4ull * R * depth);                 // q_pack
  o[n++] = take(at, 8ull * R);                         // head [2][R]
  o[n++] = take(at, 4ull * R);                         // score
  o[n++] = take(at, 4ull * R);                         // src_of
  o[n++] = take(at, 4ull * R);                         // score_nc
  o[n++] = take(at, 12ull * RC);                       // best [3][RC]
  // sent, and in records form each PE's record cursor after it
  o[n++] = take(at, 4ull * (n_phases > 0 ? (records ? 2 : 1) * P : 0));
  o[n++] = take(at, 4ull * F);                         // f_links
  o[n++] = take(at, 4ull * F);                         // f_drop
  o[n++] = take(at, 4ull * F);                         // f_onset
  o[n++] = take(at, 4ull * F);                         // f_act
  o[n++] = take(at, 4ull * n_phases);                  // ph_total
  o[n++] = take(at, 4ull * n_phases);                  // ph_done
  o[n++] = take(at, 4ull * CTL_WORDS);                 // ctl
  for (int k = 0; k < 10; ++k) o[n++] = take(at, 2ull * R);  // 16-bit
  o[n++] = take(at, R);                                // q_len
  o[n++] = take(at, 2ull * R);                         // flags [2][R]
  o[n++] = take(at, R);                                // cap
  o[n++] = take(at, R);                                // stat
  o[n++] = take(at, R);                                // room_nc
  o[n++] = take(at, R);                                // q_head
  o[n++] = take(at, R);                                // inj_v
  if (s != nullptr) {
    n = 0;
    int32_t** i32[7] = {&s->q_pack, &s->head,     &s->score, &s->src_of,
                        &s->score_nc, &s->best, &s->sent};
    for (int k = 0; k < 7; ++k)
      *i32[k] = reinterpret_cast<int32_t*>(base + o[n++]);
    s->f_links = reinterpret_cast<int32_t*>(base + o[n++]);
    s->f_drop = reinterpret_cast<float*>(base + o[n++]);
    s->f_onset = reinterpret_cast<int32_t*>(base + o[n++]);
    s->f_act = reinterpret_cast<int32_t*>(base + o[n++]);
    s->ph_total = reinterpret_cast<int32_t*>(base + o[n++]);
    s->ph_done = reinterpret_cast<int32_t*>(base + o[n++]);
    s->ctl = reinterpret_cast<int32_t*>(base + o[n++]);
    s->nxt = reinterpret_cast<int16_t*>(base + o[n++]);
    s->nphys = reinterpret_cast<int16_t*>(base + o[n++]);
    s->wait = reinterpret_cast<uint16_t*>(base + o[n++]);
    s->phys = reinterpret_cast<int16_t*>(base + o[n++]);
    s->prio = reinterpret_cast<int16_t*>(base + o[n++]);
    s->inj_pe = reinterpret_cast<int16_t*>(base + o[n++]);
    s->act = reinterpret_cast<int16_t*>(base + o[n++]);
    s->nphys_nc = reinterpret_cast<int16_t*>(base + o[n++]);
    s->dst_v = reinterpret_cast<int16_t*>(base + o[n++]);
    s->orig = reinterpret_cast<int16_t*>(base + o[n++]);
    uint8_t** u8[7] = {&s->q_len,   &s->flags,  &s->cap,  &s->stat,
                       &s->room_nc, &s->q_head, &s->inj_v};
    for (int k = 0; k < 7; ++k) *u8[k] = base + o[n++];
  }
  return at;
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
  const uint8_t* inj;       // [B, cycles, P] bool
  const int16_t* dst;       // [B, cycles, P]
  const int16_t* route;     // [L1, P]
  const int32_t* kind;      // [L1]
  const int32_t* prio;      // [L1]
  const int32_t* cap;       // [L1]
  const int32_t* phys;      // [L1] (dummy row -> n_phys)
  const uint8_t* is_sink;   // [L1] bool
  const int32_t* inj_pe;    // [L1] PE injecting into this row, or -1
  const uint8_t* contends;  // [L1] the row is in some row of cand
  const int16_t* orig;      // [L1] the row's id in the geometry's order
  int32_t* q_len_out;       // [B, L1]
  int32_t* m_scal_out;      // [B, 8]
  int32_t* m_kind_out;      // [B, 3, 8]
  int32_t* passes_out;      // [B] arbitration passes run
  // Trace replay (TRACE): per-point phase tables and completion cycles.
  const int32_t* ph_dst;    // [B, n_phases, P]
  const int32_t* ph_flits;  // [B, n_phases, P]
  const int32_t* ph_total;  // [B, n_phases]
  int32_t* ph_done_out;     // [B, n_phases]
  // Records form (REC): each source's first record of a phase, and each
  // record's destination and running end.
  const int32_t* rec_start;  // [B, n_phases, P]
  const int32_t* rec_dst;    // [B, n_rec]
  const int32_t* rec_end;    // [B, n_rec]
  // Fault injection (FAULTS): per-point entries and the uniform stream.
  const float* fault_u;     // [B, cycles, F]
  const int32_t* f_links;   // [B, F] queue ids (pad = L)
  const float* f_drop;      // [B, F] (pad = 0)
  const int32_t* f_onset;   // [B, F]
  // Counters: per CTA (blockIdx.x), the SM cycles thread 0 waited at the
  // cycle loop's barriers and the cycles of the whole loop; null = off.
  long long* clock_out;     // [B, C, 2]
  int L1, P, NP1, depth, cycles, warmup, starv, arb_iters, diagnostics,
      pow2, n_phases, strict_barrier, watchdog, F, n_rec;
  // Cluster: C CTAs per point, R rows and RC channels per CTA, and the
  // multipliers that divide a row or channel id by R or RC (__umulhi).
  int C, R, RC;
  unsigned magic_r, magic_c;
};

// Where a row (or channel) lives: CTA `rank(id)` of the cluster, at local
// index id - rank * n.  With CL false (C == 1) every id is local and this
// compiles away.
template <bool CL>
struct Split {
  int n;           // rows (channels) per CTA
  unsigned magic;  // id / n == __umulhi(id, magic) for ids below 2^16
  int me;          // this CTA's rank
  __device__ __forceinline__ int rank(int id) const {
    return CL ? (int)__umulhi((unsigned)id, magic) : 0;
  }
  // Element `id` of a split array: in this CTA's shared memory or, through
  // distributed shared memory, in another CTA's.
  template <typename T>
  __device__ __forceinline__ T& at(T* p, int id) const {
    if constexpr (!CL) {
      return p[id];
    } else {
      const int rk = rank(id);
      T* base = rk == me ? p : cg::this_cluster().map_shared_rank(p, rk);
      return base[id - rk * n];
    }
  }
};

// Shared memory of CTA `rank` (a no-op mapping for one's own rank).
template <typename T>
__device__ __forceinline__ T* of_rank(T* p, int rank, int me) {
  return rank == me ? p : cg::this_cluster().map_shared_rank(p, rank);
}

// A barrier over the whole cluster, with release/acquire ordering of
// shared memory across its CTAs (barrier.cluster arrive/wait by every
// thread); a block barrier when C == 1.
template <bool CL>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (CL)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// One barrier of the cycle loop, `sync`.  With the counters on (CLOCK),
// thread 0 adds the SM cycles it spent in it to `*waited`, in shared
// memory, so that nothing is held in a register across the barrier.
template <bool CLOCK, typename Sync>
__device__ __forceinline__ int counted(long long* waited, Sync sync) {
  if constexpr (!CLOCK) {
    return sync();
  } else {
    if (threadIdx.x == 0) *waited -= clock64();
    const int r = sync();
    if (threadIdx.x == 0) *waited += clock64();
    return r;
  }
}

// The kernel's body; noc_step_kernel runs it with the counters off and
// noc_step_clocked with them on.
template <bool TRACE, bool REC, bool FAULTS, bool CL, bool CLOCK>
__device__ __forceinline__ void noc_step_body(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem s;
  carve(&s, smem, p.R, p.RC, p.depth, p.P, p.F, p.n_phases, REC);
  const int me = CL ? (int)cg::this_cluster().block_rank() : 0;
  const Split<CL> rows{p.R, p.magic_r, me}, chans{p.RC, p.magic_c, me};
  const int b = blockIdx.x / p.C, tid = threadIdx.x, nt = blockDim.x;
  const int L1 = p.L1, L = L1 - 1, P = p.P, D = p.depth, R = p.R;
  const int r_lo = me * R, n_rows = max(0, min(R, L1 - r_lo));
  const int c_lo = me * p.RC, n_ch = max(0, min(p.RC, p.NP1 - c_lo));
  const uint8_t* inj = p.inj + (size_t)b * p.cycles * P;
  const int16_t* dst = p.dst + (size_t)b * p.cycles * P;
  const int NPH = p.n_phases;
  const int32_t* ph_dst = p.ph_dst + (size_t)b * NPH * P;
  const int32_t* ph_flits = p.ph_flits + (size_t)b * NPH * P;
  const int32_t* rec_start = p.rec_start + (size_t)b * NPH * P;
  const int32_t* rec_dst = p.rec_dst + (size_t)b * p.n_rec;
  const int32_t* rec_end = p.rec_end + (size_t)b * p.n_rec;
  const float* fault_u = p.fault_u + (size_t)b * p.cycles * p.F;
  // wait is kept saturated at the starvation limit: only min(wait, starv)
  // is ever read, so the saturated counter gives the same scores.
  const int starv = p.starv;
  int32_t* ctl = s.ctl;
  long long* const waited = reinterpret_cast<long long*>(ctl + K_WAITED);
  long long* const loop = reinterpret_cast<long long*>(ctl + K_LOOP);
  auto block_sync = [] {
    __syncthreads();
    return 0;
  };
  auto all_sync = [] {
    cluster_sync<CL>();
    return 0;
  };

  // --- set-up: this CTA's static rows, zeroed state ---------------------
  for (int lr = tid; lr < n_rows; lr += nt) {
    const int r = r_lo + lr;
    s.phys[lr] = (int16_t)p.phys[r];
    s.cap[lr] = (uint8_t)min(p.cap[r], 255);  // q_len <= depth < 255
    s.prio[lr] = (int16_t)p.prio[r];
    const unsigned k = (unsigned)p.kind[r];
    s.stat[lr] = (uint8_t)((k < 8 ? (int)k : NO_KIND) |
                           (p.is_sink[r] ? S_SINK : 0) |
                           (p.contends[r] ? S_CONTENDS : 0));
    s.inj_pe[lr] = (int16_t)p.inj_pe[r];
    s.orig[lr] = p.orig[r];
    s.q_len[lr] = 0;
    s.wait[lr] = 0;
    s.src_of[lr] = -1;
    s.q_head[lr] = 0;
    for (int k2 = 0; k2 < D; ++k2) s.q_pack[lr * D + k2] = 0;
  }
  for (int i = tid; i < 3 * p.RC; i += nt) s.best[i] = -1;
  for (int i = tid; i < CTL_WORDS; i += nt) ctl[i] = 0;
  if constexpr (FAULTS) {
    for (int f = tid; f < p.F; f += nt) {
      s.f_links[f] = p.f_links[(size_t)b * p.F + f];
      s.f_drop[f] = p.f_drop[(size_t)b * p.F + f];
      s.f_onset[f] = p.f_onset[(size_t)b * p.F + f];
    }
  }
  if constexpr (TRACE) {
    for (int i = tid; i < P; i += nt) s.sent[i] = 0;
    if constexpr (REC)
      for (int i = tid; i < P; i += nt) s.sent[P + i] = rec_start[i];
    for (int i = tid; i < NPH; i += nt) {
      s.ph_total[i] = p.ph_total[(size_t)b * NPH + i];
      s.ph_done[i] = -1;
    }
  }
  int passes = 0;    // arbitration passes of this point (every rank alike)
  int pass_no = 0;   // running pass count: the parity of the pass's slots
  cluster_sync<CL>();
  if (CLOCK && tid == 0) *loop = clock64();

  for (int cycle = 0; cycle < p.cycles; ++cycle) {
    int* cyc = ctl + K_CYC + (cycle & 1) * N_CYC;
    int32_t* head = s.head + (cycle & 1) * R;
    // --- 1. routing and arbitration scores (+ this cycle's fault flags) -
    if constexpr (FAULTS) {
      for (int f = tid; f < p.F; f += nt)
        s.f_act[f] = fault_u[(size_t)cycle * p.F + f] < s.f_drop[f] &&
                     cycle >= s.f_onset[f];
    }
    // The first pass reads its rows' flags from the slot a pass before it
    // would have written: active alone, win and feas clear.  The other
    // slot starts clear too: the passes visit only the active rows, listed
    // here (in no particular order: every pass is order-free).
    uint8_t* first = s.flags + ((pass_no + 1) & 1) * R;
    uint8_t* other = s.flags + (pass_no & 1) * R;
    for (int base = 0; base < n_rows; base += nt) {
      const int lr = base + tid;
      bool active = false;
      if (lr < n_rows) {
        const int r = r_lo + lr;
        const int hp = s.q_pack[lr * D + s.q_head[lr]];
        head[lr] = hp;  // pre-move head: enqueue reads it after the move
        const bool valid = s.q_len[lr] > 0;
        const int hd = clampi((hp & 2047) - 1, 0, P - 1);
        const int pe = s.inj_pe[lr];
        // The streams' loads go out with the route table's, so stage 4
        // does not wait on device memory.
        if (pe >= 0) {
          s.inj_v[lr] = inj[(size_t)cycle * P + pe];
          if constexpr (!TRACE) s.dst_v[lr] = dst[(size_t)cycle * P + pe];
        }
        const int nx = valid ? (int)p.route[(size_t)r * P + hd] : -1;
        active = valid && nx >= 0;
        s.nxt[lr] = (int16_t)nx;
        first[lr] = active ? F_ACTIVE : 0;
        other[lr] = 0;
        s.nphys[lr] = rows.at(s.phys, clampi(nx, 0, L));
        const int wt = s.wait[lr];
        const int eff = s.prio[lr] * 2 + (wt < starv ? wt : starv);
        s.score[lr] = eff * p.pow2 + ((s.orig[lr] + cycle) & (p.pow2 - 1));
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, active);
      int at = 0;
      if ((tid & 31) == 0 && ballot)
        at = atomicAdd(ctl + K_NACT, __popc(ballot));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (active)
        s.act[at + __popc(ballot & ((1u << (tid & 31)) - 1))] = (int16_t)lr;
    }
    // The first pass's scatter reads only this CTA's rows.
    counted<CLOCK>(waited, block_sync);
    const int n_act = ctl[K_NACT];

    // --- 2. grant / re-arbitrate fixpoint, counter from 1 ---------------
    // The row-max over each output channel's contenders is a scatter:
    // every contending row raises its channel's maximum.  The reference
    // gathers over the channel's structural candidates (cand); every route
    // hop is node-local and cand lists every queue arriving at the
    // channel's node, so a row that contends for a channel is one of its
    // candidates and the two maxima are equal.  A row contends if it was
    // active and not an infeasible winner of the last pass (the
    // re-arbitration, read inline).
    auto contends = [](int fl) {
      return (fl & F_ACTIVE) && (!(fl & F_WIN) || (fl & F_FEAS));
    };
    // The maxima have three slots by pass: pass k reads slot k % 3, raises
    // slot (k + 1) % 3 for the next pass, and clears slot (k + 2) % 3,
    // which pass k - 1 read; the barrier between two passes separates each
    // slot's clearing, raising and reading.  The first pass's maxima come
    // from the rows active after stage 1.
    for (int i = tid; i < n_act; i += nt) {
      const int lr = s.act[i];
      if (s.stat[lr] & S_CONTENDS)
        atomicMax(&chans.at(s.best + (pass_no % 3) * p.RC, s.nphys[lr]),
                  s.score[lr]);
    }
    counted<CLOCK>(waited, all_sync);
    // Each pass reads the last pass's flags (prev) and writes its rows'
    // flags to its own slot, so nothing a pass reads in another CTA is
    // rewritten while it reads.
    int it = 0;
    for (;;) {
      ++it;
      const int slot = pass_no % 3, next = (pass_no + 1) % 3;
      const uint8_t* prev = s.flags + ((pass_no + 1) & 1) * R;
      uint8_t* flags = s.flags + (pass_no & 1) * R;
      const int32_t* best = s.best + slot * p.RC;
      int32_t* best_next = s.best + next * p.RC;
      if (tid == 0) {
        // The other slot of the counters is free again: rank 0 read it
        // (trace mode) and this CTA folded it into its partials before
        // this cycle's first cluster barrier.  The next pass's fixpoint
        // flag slot was last read two barriers ago.
        if (it == 1)
          for (int k = 0; k < N_CYC; ++k)
            ctl[K_CYC + ((cycle + 1) & 1) * N_CYC + k] = 0;
        if (CL) ctl[K_BAD + next] = 0;
      }
      for (int lc = tid; lc < n_ch; lc += nt)
        s.best[((pass_no + 2) % 3) * p.RC + lc] = -1;
      // Winners and feasibility in one stage: a row computes its own win
      // and, from the same inputs, the win of the queue its head targets.
      // A grant into a full queue is feasible only if that queue's own
      // head departs this cycle; q_len is still the pre-move length.  (An
      // inactive row neither wins nor contends, and its feasibility is
      // never read: its flags stay clear.)  A row that contends in the
      // next pass raises the next pass's maximum now; if this pass is the
      // last, stage 3 clears that slot.
      int bad = 0;
      for (int i = tid; i < n_act; i += nt) {
        const int lr = s.act[i];
        const int nc = clampi(s.nxt[lr], 0, L);
        int score_nc, nphys_nc, room_nc;
        if (it == 1) {
          score_nc = s.score_nc[lr] = rows.at(s.score, nc);
          nphys_nc = s.nphys_nc[lr] = rows.at(s.nphys, nc);
          room_nc = rows.at(s.cap, nc) - rows.at(s.q_len, nc);
          s.room_nc[lr] = (uint8_t)room_nc;
        } else {
          score_nc = s.score_nc[lr];
          nphys_nc = s.nphys_nc[lr];
          room_nc = s.room_nc[lr];
        }
        const bool a = contends(prev[lr]);
        const bool w = a && s.score[lr] == chans.at(best, s.nphys[lr]);
        const bool an = contends(rows.at(prev, nc));
        const int wn = an && score_nc == chans.at(best, nphys_nc);
        // (q_len[nc] - wn) < cap[nc], with room = cap - q_len
        const bool f = room_nc + wn > 0;
        const int fl = (a ? F_ACTIVE : 0) | (w ? F_WIN : 0) | (f ? F_FEAS : 0);
        flags[lr] = (uint8_t)fl;
        bad |= w && !f;
        if (contends(fl) && (s.stat[lr] & S_CONTENDS))
          atomicMax(&chans.at(best_next, s.nphys[lr]), s.score[lr]);
      }
      int any;
      if constexpr (!CL) {
        any = counted<CLOCK>(waited,
                             [bad] { return __syncthreads_or(bad); });
      } else {
        int* flag = ctl + K_BAD + slot;
        if (__any_sync(0xffffffffu, bad) && (tid & 31) == 0)
          for (int rk = 0; rk < p.C; ++rk) *of_rank(flag, rk, me) = 1;
        counted<CLOCK>(waited, all_sync);
        any = *(volatile int*)flag;
      }
      ++pass_no;
      if (!any || it >= p.arb_iters) break;
    }
    passes += it;
    const uint8_t* flags = s.flags + ((pass_no - 1) & 1) * R;  // the last
    if (tid == 0) ctl[K_NACT] = 0;  // every pass has read the list length
    // The last pass raised the maxima of a pass that will not run: clear
    // them before the next cycle's first pass raises that slot (after the
    // cluster barrier that ends stage 3).
    for (int lc = tid; lc < n_ch; lc += nt)
      s.best[(pass_no % 3) * p.RC + lc] = -1;

    // --- 3. dequeue, deliveries, aging, fault drops ----------------------
    // A sender raises its target row's src_of, the scatter form of the
    // reference's gather over the fan-in table (intab lists every queue
    // that can route into a row, for the same reason as above); the
    // reference keeps the largest sender id in its own row order, so the
    // key is that id above this kernel's.
    int deliv = 0, lat = 0, moved = 0, resid = 0, droute = 0, fdrop = 0;
    for (int lr = tid; lr < n_rows; lr += nt) {
      const int r = r_lo + lr;
      const int ql = s.q_len[lr];
      const bool valid = ql > 0;
      const int nx = s.nxt[lr];
      const int nc = clampi(nx, 0, L);
      const int fl = flags[lr];
      const bool won = fl & F_WIN, f = fl & F_FEAS;
      const bool winner = won && f;
      const bool drop_route = valid && nx < 0;
      const bool deq = winner || drop_route;
      const int st_nc = rows.at(s.stat, nc);
      const bool sink = st_nc & S_SINK;
      // A winner whose wire is faulty this cycle leaves its queue (and
      // counts as moved) but never arrives.
      bool lost_on_wire = false;
      if constexpr (FAULTS) {
        if (winner)
          for (int k = 0; k < p.F; ++k)
            lost_on_wire |= s.f_act[k] && s.f_links[k] == nc;
      }
      if (winner && !sink && !lost_on_wire)
        atomicMax(&rows.at(s.src_of, nc), (s.orig[lr] << 15) | r);
      if (winner && sink && !lost_on_wire) {
        ++deliv;
        lat += cycle - (head[lr] >> 11);
      }
      moved += winner;
      resid += won && !f;
      droute += drop_route;
      fdrop += lost_on_wire;
      const int wt = s.wait[lr];
      s.wait[lr] = (valid && !deq) ? (uint16_t)(wt < starv ? wt + 1 : starv)
                                   : (uint16_t)0;
      if (deq) {
        const int h = s.q_head[lr] + 1;
        s.q_head[lr] = (uint8_t)(h == D ? 0 : h);
        s.q_len[lr] = (uint8_t)(ql - 1);
      }
      if (p.diagnostics) {
        const int kw = s.stat[lr] & 15, ks = st_nc & 15;
        if (winner && kw != NO_KIND) atomicAdd(&cyc[C_WINS + kw], 1);
        if (valid && nx >= 0 && !winner && ks != NO_KIND)
          atomicAdd(&cyc[C_STALLS + ks], 1);
      }
    }
    block_add(&cyc[C_DELIV], deliv);
    block_add(&cyc[C_LAT], lat);
    block_add(&cyc[C_MOVED], moved);
    block_add(&cyc[C_RESID], resid);
    block_add(&cyc[C_DROP_ROUTE], droute);
    if constexpr (FAULTS) block_add(&cyc[C_FAULT], fdrop);
    counted<CLOCK>(waited, all_sync);

    // --- 4. enqueue, then injection --------------------------------------
    // Nothing routes into an inject queue, and each PE's inject queue is
    // the one row whose inj_pe names it, so every row is written by its
    // own thread only, from post-dequeue lengths.  In trace mode the same
    // thread owns its PE's `sent` count, and restarts it at 0 when the
    // last cycle closed a phase.
    int cur = 0;
    bool phase_active = false, restart = false;
    if constexpr (TRACE) {
      const int sc = *of_rank(ctl + K_CUR, 0, me);
      phase_active = sc < NPH;  // the unclipped cursor
      cur = clampi(sc, 0, NPH - 1);
      restart = *of_rank(ctl + K_DONE, 0, me) != 0;
    }
    int offer = 0, accd = 0, dinj = 0, lost = 0;
    for (int lr = tid; lr < n_rows; lr += nt) {
      const int key = s.src_of[lr];  // the sender's geometry id, then ours
      const int src = key >= 0 ? key & 0x7FFF : -1;
      s.src_of[lr] = -1;
      const int ql = s.q_len[lr];
      const int cap = s.cap[lr];
      const bool has_in = src >= 0;
      const bool lost_row = has_in && ql >= cap;
      const bool enq = has_in && !lost_row;
      lost += lost_row;
      const int pe = s.inj_pe[lr];
      bool acc = false;
      int dst_pe = 0;
      if (pe >= 0) {
        bool want = s.inj_v[lr];
        const bool room = ql < cap;
        if constexpr (TRACE) {
          const size_t at = (size_t)cur * P + pe;
          const int sent = restart ? 0 : s.sent[pe];
          want = want && phase_active && ph_flits[at] - sent > 0;
          if constexpr (REC) {
            // The PE's current record, loaded beside ph_flits: a PE past
            // its last record (clipped for the loads) is gated off above.
            int k = restart ? rec_start[at] : s.sent[P + pe];
            const int kc = k < p.n_rec ? k : p.n_rec - 1;
            const int end = rec_end[kc];
            dst_pe = rec_dst[kc];
            acc = want && room;
            if (acc && sent + 1 == end) ++k;
            s.sent[P + pe] = k;
          } else {
            dst_pe = ph_dst[at];
            acc = want && room;
          }
          s.sent[pe] = sent + acc;
        } else {
          dst_pe = s.dst_v[lr];
          acc = want && room;
          offer += want;
          dinj += want && !room;
        }
        accd += acc;
      }
      if (enq || acc) {  // then ql < cap <= depth
        const int val =
            enq ? rows.at(head, src) : ((cycle << 11) | (dst_pe + 1));
        const int tail = s.q_head[lr] + ql;
        s.q_pack[lr * D + (tail < D ? tail : tail - D)] = val;
        s.q_len[lr] = (uint8_t)(ql + 1);
      }
    }
    block_add(&cyc[C_OFFER], offer);
    block_add(&cyc[C_ACC], accd);
    block_add(&cyc[C_DROP_INJ], dinj);
    block_add(&cyc[C_LOST_ENQ], lost);
    // Stage 1 next rewrites only this CTA's rows and the other head slot,
    // so a block barrier ends the cycle; trace mode's phase barrier reads
    // every rank's counts, which takes the whole cluster.
    if constexpr (TRACE)
      counted<CLOCK>(waited, all_sync);
    else
      counted<CLOCK>(waited, block_sync);

    // --- 5. metric accumulation (warmup-gated; `lost` ungated) ----------
    // Each CTA folds its own counts into its partials, one thread per
    // accumulator; rank 0 adds the partials at the end.  Trace mode:
    // offered := accepted and a refused injection is not a drop (it
    // retries next cycle).
    if (tid < N_SCALARS - 1 + 16) {
      const int g = cycle >= p.warmup;
      int v;
      switch (tid) {
        case DELIVERED: v = g * cyc[C_DELIV]; break;
        case OFFERED: v = g * (TRACE ? cyc[C_ACC] : cyc[C_OFFER]); break;
        case ACCEPTED: v = g * cyc[C_ACC]; break;
        case DROPPED:
          v = g * (cyc[C_DROP_ROUTE] + cyc[C_LOST_ENQ] +
                   (FAULTS ? cyc[C_FAULT] : 0) +
                   (TRACE ? 0 : cyc[C_DROP_INJ]));
          break;
        case LOST: v = cyc[C_LOST_ENQ] + cyc[C_RESID]; break;
        case LAT_SUM: v = g * cyc[C_LAT]; break;
        case MOVED: v = g * cyc[C_MOVED]; break;
        default: v = g * cyc[C_WINS + tid - (N_SCALARS - 1)]; break;
      }
      if (tid < N_SCALARS - 1)
        ctl[K_SCAL + tid] += v;
      else
        ctl[K_KIND + tid - (N_SCALARS - 1)] += v;
    }
    if constexpr (TRACE) {
      if (me == 0 && tid == 32) {
        int* m_scal = ctl + K_SCAL;
        // --- 6. phase barrier, on the cycle's closed counts of every
        // rank (this cycle's last barrier spans the cluster); the others
        // read the cursor after the next cycle's cluster barriers.
        int deliv_all = 0, hard_all = 0, acc_all = 0, moved_all = 0;
        for (int rk = 0; rk < p.C; ++rk) {
          const int* c = of_rank(ctl + K_CYC + (cycle & 1) * N_CYC, rk, me);
          deliv_all += c[C_DELIV];
          hard_all += c[C_DROP_ROUTE] + c[C_LOST_ENQ] +
                      (FAULTS ? c[C_FAULT] : 0);
          acc_all += c[C_ACC];
          moved_all += c[C_MOVED];
        }
        const int retired =
            p.strict_barrier ? deliv_all : deliv_all + hard_all;
        const int credit = ctl[K_CREDIT] + retired;
        const int sc = ctl[K_CUR];
        const int cur0 = clampi(sc, 0, NPH - 1);
        const bool active_ph = sc < NPH;
        const int total = s.ph_total[cur0];
        const bool done_now = active_ph && credit >= total;
        if (done_now) s.ph_done[cur0] = cycle;
        ctl[K_CUR] = sc + done_now;
        ctl[K_CREDIT] = done_now ? 0 : credit;
        ctl[K_DONE] = done_now;
        if (p.watchdog) {
          const bool progress = retired > 0 || acc_all > 0 || moved_all > 0;
          ctl[K_STALL] = (active_ph && !done_now && !progress)
                             ? ctl[K_STALL] + 1
                             : 0;
          if (active_ph && !done_now && ctl[K_STALL] >= p.watchdog) {
            s.ph_done[cur0] = -2 - cycle;
            m_scal[STALL_CREDIT] += total - ctl[K_CREDIT];
            ctl[K_CUR] = NPH;
          }
        }
      }
    }
    // The next writes to this slot of cyc[] come two cycles on, after it is
    // cleared behind the next cycle's first cluster barrier.
  }
  if (CLOCK && tid == 0) {
    p.clock_out[2 * (size_t)blockIdx.x] = *waited;
    p.clock_out[2 * (size_t)blockIdx.x + 1] = clock64() - *loop;
  }
  cluster_sync<CL>();

  for (int lr = tid; lr < n_rows; lr += nt)
    p.q_len_out[(size_t)b * L1 + r_lo + lr] = s.q_len[lr];
  if (me == 0) {
    if (tid < N_SCALARS) {
      int v = 0;
      for (int rk = 0; rk < p.C; ++rk) v += of_rank(ctl + K_SCAL, rk, me)[tid];
      p.m_scal_out[b * N_SCALARS + tid] = v;
    }
    if (tid < N_KIND_ROWS * 8) {
      int v = 0;
      if (tid < 16)
        for (int rk = 0; rk < p.C; ++rk)
          v += of_rank(ctl + K_KIND, rk, me)[tid];
      p.m_kind_out[b * N_KIND_ROWS * 8 + tid] = v;
    }
    if (tid == 0) p.passes_out[b] = passes;
    if constexpr (TRACE)
      for (int i = tid; i < NPH; i += nt)
        p.ph_done_out[(size_t)b * NPH + i] = s.ph_done[i];
  }
  // No CTA leaves while rank 0 may still read its shared memory.
  cluster_sync<CL>();
}

template <bool TRACE, bool REC, bool FAULTS, bool CL>
__global__ void __launch_bounds__(1024, 1) noc_step_kernel(Params p) {
  noc_step_body<TRACE, REC, FAULTS, CL, false>(p);
}

template <bool TRACE, bool REC, bool FAULTS, bool CL>
__global__ void __launch_bounds__(1024, 1) noc_step_clocked(Params p) {
  noc_step_body<TRACE, REC, FAULTS, CL, true>(p);
}

// The cost of one barrier: `iters` cluster barriers (block barriers when
// C == 1) over the CTA's threads; thread 0 of each CTA records the
// clock64() cycles they took.
__global__ void __launch_bounds__(1024, 1)
    barrier_probe(int C, int iters, long long* cycles_out) {
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (C > 1)
      cluster_sync<true>();
    else
      __syncthreads();
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles_out[blockIdx.x] = t1 - t0;
}

template <typename Kernel>
cudaError_t launch_clustered(Kernel kernel, int blocks, int C, int threads,
                             size_t bytes, cudaStream_t stream,
                             const Params* p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, *p);
}

// The mode's kernel, its counters on when p->clock_out is set.
template <bool TRACE, bool REC, bool FAULTS, bool CL>
cudaError_t launch_mode(int batch, int C, size_t bytes, cudaStream_t s,
                        const Params* p) {
  if (p->clock_out != nullptr)
    return launch_clustered(noc_step_clocked<TRACE, REC, FAULTS, CL>, batch,
                            C, 1024, bytes, s, p);
  return launch_clustered(noc_step_kernel<TRACE, REC, FAULTS, CL>, batch, C,
                          1024, bytes, s, p);
}

template <bool CL>
cudaError_t dispatch(bool trace, bool records, bool faults, int batch, int C,
                     size_t bytes, cudaStream_t s, const Params* p) {
  if (trace && records && faults)
    return launch_mode<true, true, true, CL>(batch, C, bytes, s, p);
  if (trace && records)
    return launch_mode<true, true, false, CL>(batch, C, bytes, s, p);
  if (trace && faults)
    return launch_mode<true, false, true, CL>(batch, C, bytes, s, p);
  if (trace) return launch_mode<true, false, false, CL>(batch, C, bytes, s, p);
  if (faults) return launch_mode<false, false, true, CL>(batch, C, bytes, s, p);
  return launch_mode<false, false, false, CL>(batch, C, bytes, s, p);
}

unsigned magic(int divisor) {
  return (unsigned)(((1ull << 32) + (unsigned long long)divisor - 1) /
                    (unsigned long long)divisor);
}

}  // namespace

extern "C" {

const char* noc_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of one CTA's shared memory for R rows and RC channels.
long long noc_step_shared_bytes(int R, int RC, int depth, int P, int F,
                                int n_phases, int records) {
  return (long long)carve(nullptr, nullptr, R, RC, depth, P, F, n_phases,
                          records);
}

// How many clusters of C CTAs with `bytes` of shared memory each the card
// can hold at once (cudaOccupancyMaxActiveClusters on the statistical
// kernel), or -1 with the error in *err.
int noc_step_max_active_clusters(int C, long long bytes, int* err) {
  auto kernel = noc_step_kernel<false, false, false, true>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int n = -1;
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(1024);
    cfg.dynamicSmemBytes = (size_t)bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  }
  *err = (int)e;
  return e == cudaSuccess ? n : -1;
}

// One cluster of C CTAs of `threads` threads running `iters` barriers;
// cycles_out[C] receives each CTA's clock64() count.
int noc_step_barrier_probe(int C, int threads, int iters, void* cycles_out,
                           void* stream) {
  (void)cudaGetLastError();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, barrier_probe, C, iters,
                                     static_cast<long long*>(cycles_out));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Launches the kernel on `stream`: one cluster of C CTAs per point (grid =
// batch * C), in the mode its operands ask for: trace replay when
// n_phases > 0 (in records form when n_rec > 0), fault injection when
// F > 0.  A non-null `clock_out`
// ([batch, C, 2] int64) turns the barrier-wait counters on.  Returns
// cudaGetLastError() as an int (0 = launched).
int noc_step_launch(const void* inj, const void* dst, const void* route,
                    const void* kind, const void* prio, const void* cap,
                    const void* phys, const void* is_sink,
                    const void* inj_pe, const void* contends,
                    const void* orig, void* q_len_out, void* m_scal_out,
                    void* m_kind_out,
                    void* passes_out, const void* ph_dst,
                    const void* ph_flits, const void* ph_total,
                    void* ph_done_out, const void* rec_start,
                    const void* rec_dst, const void* rec_end,
                    const void* fault_u,
                    const void* f_links, const void* f_drop,
                    const void* f_onset, void* clock_out, int batch,
                    int L1, int P, int NP1,
                    int depth, int cycles, int warmup, int starv,
                    int arb_iters, int diagnostics, int pow2, int n_phases,
                    int strict_barrier, int watchdog, int F, int n_rec,
                    int C, void* stream) {
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
  p.contends = static_cast<const uint8_t*>(contends);
  p.orig = static_cast<const int16_t*>(orig);
  p.q_len_out = static_cast<int32_t*>(q_len_out);
  p.m_scal_out = static_cast<int32_t*>(m_scal_out);
  p.m_kind_out = static_cast<int32_t*>(m_kind_out);
  p.passes_out = static_cast<int32_t*>(passes_out);
  p.ph_dst = static_cast<const int32_t*>(ph_dst);
  p.ph_flits = static_cast<const int32_t*>(ph_flits);
  p.ph_total = static_cast<const int32_t*>(ph_total);
  p.ph_done_out = static_cast<int32_t*>(ph_done_out);
  p.rec_start = static_cast<const int32_t*>(rec_start);
  p.rec_dst = static_cast<const int32_t*>(rec_dst);
  p.rec_end = static_cast<const int32_t*>(rec_end);
  p.fault_u = static_cast<const float*>(fault_u);
  p.f_links = static_cast<const int32_t*>(f_links);
  p.f_drop = static_cast<const float*>(f_drop);
  p.f_onset = static_cast<const int32_t*>(f_onset);
  p.clock_out = static_cast<long long*>(clock_out);
  p.L1 = L1;
  p.P = P;
  p.NP1 = NP1;
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
  p.n_rec = n_rec;
  const int records = n_phases > 0 && n_rec > 0;
  p.C = C;
  p.R = (L1 + C - 1) / C;
  p.RC = (NP1 + C - 1) / C;
  p.magic_r = magic(p.R);
  p.magic_c = magic(p.RC);
  const size_t bytes =
      carve(nullptr, nullptr, p.R, p.RC, depth, P, F, n_phases, records);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();  // clear any stale error before this launch
  cudaError_t err;
  if (C > 1)
    err = dispatch<true>(n_phases > 0, records, F > 0, batch, C, bytes, s,
                         &p);
  else
    err = dispatch<false>(n_phases > 0, records, F > 0, batch, C, bytes, s,
                          &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
