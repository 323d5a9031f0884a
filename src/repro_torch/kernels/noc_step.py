"""The NoC simulator's cycle loop: a plain PyTorch twin and a CUDA kernel.

``cycle_step`` is the step math of the reference's
``kernels/noc_step.py`` (route -> arbitrate -> move -> inject -> count) in
plain tensor code, with a leading batch dimension written out: every state
tensor is ``[B, ...]`` and the geometry is shared by the whole batch, which
is how ``core.sweep`` runs a grid of points on one topology.  ``run_plain``
loops it over cycles.  It is the oracle of the CUDA kernel.

The step has the reference's three modes: statistical traffic, trace
replay (``trace=``: phase-gated injection with a barrier between phases,
``strict_barrier`` and the stall ``watchdog``; in records form a source
walks an ordered list of destinations within a phase) and runtime fault
injection (``faults=`` with a per-cycle ``fault_u`` row: granted flits
crossing a faulty wire are dropped).  Trace replay and faults combine.

``run_fused`` runs the whole cycle loop as one launch of the hand-written
kernel ``csrc/noc_step.cu`` (the port of the reference's Pallas
``_noc_step_kernel``): one thread-block cluster of C CTAs per sweep point,
its queue state in their shared memory, looping over the cycles inside the
kernel, with trace replay and faults as compile-time modes.
``cluster_plan`` picks C, the smallest cluster whose per-CTA slice fits
the card's 227 KB of shared memory per block.  ``run_fused`` takes CUDA
tensors only: it never runs the twin in its place, and a missing
compiler, a refused launch or a fault raises.  ``run_plain`` is the CPU's
path.

Every accumulator is an int32, so the twin, the kernel and the reference
agree bit for bit; there is no reduction-order slack to allow for.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import NamedTuple

import numpy as np

import torch

from repro_torch import telemetry
from repro_torch.kernels import build

# Flat metric-accumulator layout shared by the twin and the kernel: slot
# names of the [N_SCALARS] int32 vector, then the rows of the
# [N_KIND_ROWS, 8] per-queue-kind table.  KIND_QLEN is filled by
# ``core.sim`` from the final queue lengths, not per cycle; STALL_CREDIT
# records the credits the stall watchdog found unretired when it
# terminated a trace phase (0 otherwise).
(DELIVERED, OFFERED, ACCEPTED, DROPPED, LOST, LAT_SUM, MOVED,
 STALL_CREDIT) = range(8)
N_SCALARS = 8
KIND_WINS, KIND_STALLS, KIND_QLEN = range(3)
N_KIND_ROWS = 3

# The kernel's modes, and the telemetry counter of each mode's launches.
# A launch with both trace replay and faults counts under both of those
# modes.
STATISTICAL, TRACE, FAULTS = "noc_step", "noc_step[trace]", "noc_step[faults]"
LAUNCH_COUNTERS = {STATISTICAL: "noc_step.launches[statistical]",
                   TRACE: "noc_step.launches[trace]",
                   FAULTS: "noc_step.launches[faults]"}


def launches() -> dict[str, int]:
    """The kernel's launches by mode since the last ``telemetry.drain()``."""
    return {mode: telemetry.counter(name)
            for mode, name in LAUNCH_COUNTERS.items()}


def launch_modes(trace, faults) -> tuple[str, ...]:
    """The modes a launch with these operands runs."""
    modes = ((TRACE,) if trace is not None else ()) + (
        (FAULTS,) if faults is not None else ())
    return modes or (STATISTICAL,)


class IndexTables(NamedTuple):
    """Cycle-invariant int64 views of the geometry for torch indexing
    (built once per run, not per cycle)."""

    rows: torch.Tensor       # [L+1] arange
    row_col: torch.Tensor    # [L+1, 1] int32 arange
    chan_col: torch.Tensor   # [NP1, 1] int32 arange
    cand: torch.Tensor       # [NP1, Fc]
    intab: torch.Tensor      # [L+1, Fi]
    pe_src: torch.Tensor     # [P]
    inj_pec: torch.Tensor    # [L+1] inj_pe clipped to [0, P)
    kinds8: torch.Tensor     # [8, 1] int32 arange
    col_k: torch.Tensor      # [1, 1, depth] int32 arange


def index_tables(geom, depth: int) -> IndexTables:
    lp1, p_pes = geom.route.shape
    dev = geom.route.device
    i32 = dict(dtype=torch.int32, device=dev)
    return IndexTables(
        rows=torch.arange(lp1, dtype=torch.int64, device=dev),
        row_col=torch.arange(lp1, **i32)[:, None],
        chan_col=torch.arange(geom.cand.shape[0], **i32)[:, None],
        cand=geom.cand.long(),
        intab=geom.intab.long(),
        pe_src=geom.pe_src_link.long(),
        inj_pec=geom.inj_pe.clamp(0, p_pes - 1).long(),
        kinds8=torch.arange(8, **i32)[:, None],
        col_k=torch.arange(depth, **i32)[None, None, :])


def initial_state(batch: int, n_links: int, depth: int, device, *,
                  n_pes: int = 0, n_phases: int = 0, rec_start=None):
    """Zeroed carry: (packed queue words [B, L+1, depth], queue lengths
    [B, L+1], aging counters [B, L+1], scalar metrics [B, 8], per-kind
    metrics [B, 3, 8]), all int32.  With ``n_phases > 0`` (trace replay)
    the carry extends to the 10-tuple: + (phase cursor [B], per-PE flits
    sent [B, P], retired-flit credit [B], per-phase completion cycles
    [B, n_phases] initialized -1, stall-watchdog counter [B]).  With the
    record tables' ``rec_start`` [B, n_phases, P] (records form) it is the
    11-tuple: + each PE's record cursor [B, P], at its first record of
    phase 0."""
    z = dict(dtype=torch.int32, device=device)
    base = (torch.zeros((batch, n_links + 1, depth), **z),
            torch.zeros((batch, n_links + 1), **z),
            torch.zeros((batch, n_links + 1), **z),
            torch.zeros((batch, N_SCALARS), **z),
            torch.zeros((batch, N_KIND_ROWS, 8), **z))
    if n_phases <= 0:
        return base
    base += (torch.zeros((batch,), **z),
             torch.zeros((batch, n_pes), **z),
             torch.zeros((batch,), **z),
             torch.full((batch, n_phases), -1, **z),
             torch.zeros((batch,), **z))
    if rec_start is None:
        return base
    return base + (rec_start[:, 0].clone(),)


def score_pow2(n_rows: int) -> int:
    """Round-robin modulus: the power of two at or above ``L+1``, which
    keeps every queue's arbitration score unique."""
    return 1 << int(math.ceil(math.log2(n_rows)))


def cycle_step(geom, state, cycle: int, inj: torch.Tensor,
               dst: torch.Tensor, fault_u: torch.Tensor | None = None, *,
               warmup: int, starvation_limit: int, arb_iters: int,
               trace=None, faults=None, strict_barrier: bool = False,
               watchdog: int = 0, diagnostics: bool = False,
               idx: IndexTables | None = None):
    """One simulator cycle for a batch of points.

    ``inj`` is the [B, P] bool injection row and ``dst`` the [B, P] int16
    destination row of this cycle.  Returns ``(state, passes)``: the new
    state tuple and the [B] int32 count of arbitration passes each point
    needed (the first select plus one per re-arbitration).  The model and
    its order of updates are the reference's, line for line; comments mark
    where a torch idiom replaces a JAX one.

    ``trace`` switches on phase-gated replay: ``(ph_dst [B, n_phases, P],
    ph_flits [B, n_phases, P], ph_total [B, n_phases])`` int32, with
    ``state`` the 10-tuple of ``initial_state(..., n_phases=...)``.  The
    injection row is masked to PEs with flits left in the current phase,
    destinations come from the phase's map, and the cursor advances at the
    END of the cycle once the phase's flits have all retired (delivered,
    or — unless ``strict_barrier`` — dropped or lost).  ``watchdog > 0``
    ends a phase that made no progress for that many cycles, recording
    ``-2 - cycle`` and the unretired credit in ``STALL_CREDIT``.

    Records form: ``trace`` carries three more tables, ``(rec_start [B,
    n_phases, P], rec_dst [B, R], rec_end [B, R])`` (``core.sim.
    record_tables``), ``ph_flits`` holds each source's phase total, and
    ``state`` is the 11-tuple.  Each PE's record cursor names its current
    record: its destination is the cycle's, and the cursor steps on once
    the PE has sent the record's running ``rec_end``; at a phase's end it
    moves to the PE's first record of the next phase, as ``sent`` restarts.

    ``faults`` switches on fault injection: ``(links [B, F] int32 queue
    ids, drop_p [B, F] float32, onset [B, F] int32)`` with ``fault_u`` the
    [B, F] float32 uniform row of this cycle.  A flit granted a move into
    a queue named by an entry with ``fault_u < drop_p`` and
    ``cycle >= onset`` is dropped on the wire: it leaves its queue and
    counts as moved and dropped, but never arrives.  Pad entries name the
    dummy row with ``drop_p = 0`` and never fire.
    """
    if trace is None:
        q_pack, q_len, wait, m_scal, m_kind = state
    else:
        (q_pack, q_len, wait, m_scal, m_kind,
         ph_idx, sent, credit, ph_done, stall) = state[:10]
        ph_dst, ph_flits, ph_total = trace[:3]
        n_phases = ph_dst.shape[1]
        batch_ids = torch.arange(ph_idx.shape[0], device=ph_idx.device)
        # The cursor is clipped for the gathers; `active` reads it unclipped.
        cur = ph_idx.clamp(0, n_phases - 1).long()
        active = ph_idx < n_phases
        cur_flits = ph_flits[batch_ids, cur]                  # [B, P]
        # The Bernoulli row throttles bandwidth (inj_rate=1.0 -> inject as
        # fast as back-pressure allows); the phase gate does the rest.
        inj = inj & active[:, None] & (cur_flits - sent > 0)
        if len(trace) == 3:
            dst = ph_dst[batch_ids, cur]
        else:
            rec_start, rec_dst, rec_end = trace[3:]
            # A PE past its last record is gated off above; clip its cursor
            # for the gathers.
            rec = state[10]
            rec_c = rec.clamp(0, rec_dst.shape[1] - 1).long()
            dst = torch.gather(rec_dst, 1, rec_c)
            rec_end_now = torch.gather(rec_end, 1, rec_c)
    lp1, p_pes = geom.route.shape
    n_links = lp1 - 1
    depth = q_pack.shape[2]
    if idx is None:
        idx = index_tables(geom, depth)
    pow2 = score_pow2(lp1)

    # --- 1. routing: next link for every queue head ----------------------
    head_pack = q_pack[:, :, 0]
    head_born = head_pack >> 11
    valid = q_len > 0
    # torch indexing wants int64 and raises out of range: clip by hand, as
    # the reference does, before every gather.
    head_dst = ((head_pack & 2047) - 1).clamp(0, p_pes - 1).long()
    nxt = geom.route[idx.rows[None, :], head_dst].to(torch.int32)
    nxt = torch.where(valid, nxt, -1)
    # An invalid -1 clips to row 0, not to the dummy row.
    nxt_c = nxt.clamp(0, n_links)
    nxt_cl = nxt_c.long()
    nxt_phys = geom.phys[nxt_cl]
    drop_route = valid & (nxt < 0)

    # --- 2. arbitration over each output physical channel ----------------
    contend = valid & (nxt >= 0)
    eff_prio = geom.prio * 2 + wait.clamp(max=starvation_limit)
    rot = (idx.row_col[:, 0] + cycle) & (pow2 - 1)
    score = eff_prio * pow2 + rot
    cand_score = torch.where(nxt_phys[:, idx.cand] == idx.chan_col,
                             score[:, idx.cand], -1)       # [B, NP1, Fc]
    ql_t = torch.gather(q_len, 1, nxt_cl)
    cap_t = geom.cap[nxt_cl]
    nxt_phys_l = nxt_phys.long()

    def select(active):
        best = torch.where(active[:, idx.cand], cand_score, -1).amax(dim=2)
        return active & (score == torch.gather(best, 1, nxt_phys_l))

    def feasible(w):
        return (ql_t - torch.gather(w, 1, nxt_cl).to(torch.int32)) < cap_t

    # The reference's early-exit while_loop: its counter starts at 1, so at
    # most arb_iters - 1 re-arbitrations run.  A pass on a point whose
    # winner set is already feasible changes nothing, so the batch runs
    # until every point is feasible, as vmap does.
    contenders = contend
    winner = select(contenders)
    feas_w = feasible(winner)
    passes = torch.ones(q_len.shape[0], dtype=torch.int32,
                        device=q_len.device)
    for _ in range(arb_iters - 1):
        bad = (winner & ~feas_w).any(dim=1)
        if not bool(bad.any()):
            break
        passes += bad.to(torch.int32)
        contenders = contenders & (~winner | feas_w)
        winner = select(contenders)
        feas_w = feasible(winner)
    residue = winner & ~feas_w
    winner = winner & ~residue

    deq = winner | drop_route
    sink = geom.is_sink[nxt_cl]
    # Fault injection: a granted flit crossing a faulty wire is dropped on
    # the wire (it leaves its source queue but never arrives).  faulty_now
    # is a scatter-free [F] x [L+1] compare collapsed over the entries.
    if faults is not None:
        f_links, f_drop_p, f_onset = faults
        f_act = (fault_u < f_drop_p) & (cycle >= f_onset)        # [B, F]
        faulty_now = ((f_links[:, :, None] == idx.row_col[None, :, 0])
                      & f_act[:, :, None]).any(dim=1)           # [B, L+1]
        fault_drop = winner & torch.gather(faulty_now, 1, nxt_cl)
        send = winner & ~sink & ~fault_drop
        deliver = winner & sink & ~fault_drop
    else:
        fault_drop = None
        send = winner & ~sink
        deliver = winner & sink

    # --- 3. apply moves ---------------------------------------------------
    shifted = torch.cat([q_pack[:, :, 1:], torch.zeros_like(q_pack[:, :, :1])],
                        dim=2)
    q_pack = torch.where(deq[:, :, None], shifted, q_pack)
    q_len = q_len - deq.to(torch.int32)

    # Scatter-free enqueue through the structural fan-in table.
    inc = send[:, idx.intab] & (nxt_c[:, idx.intab] == idx.row_col)
    src_q = torch.where(inc, geom.intab, -1).amax(dim=2)
    has_in = src_q >= 0
    src_qc = src_q.clamp(0, n_links).long()
    # Post-dequeue lengths from here on.
    lost_enq_row = has_in & (q_len >= geom.cap)
    enq_row = has_in & ~lost_enq_row

    delivered_c = deliver.sum(dim=1)
    lat_c = torch.where(deliver, cycle - head_born, 0).sum(dim=1)
    moved_c = winner.sum(dim=1)
    wait = torch.where(valid & ~deq, wait + 1, 0)

    # --- 4. injection -----------------------------------------------------
    room = q_len[:, idx.pe_src] < geom.cap[idx.pe_src]
    acc = inj & room
    acc_row = (geom.inj_pe >= 0) & acc[:, idx.inj_pec]
    put = enq_row | acc_row
    tail = put[:, :, None] & (idx.col_k
                              == q_len.clamp(0, depth - 1)[:, :, None])
    inj_pack = (cycle << 11) | (dst[:, idx.inj_pec].to(torch.int32) + 1)
    val = torch.where(enq_row, torch.gather(head_pack, 1, src_qc), inj_pack)
    q_pack = torch.where(tail, val[:, :, None], q_pack)
    q_len = q_len + put.to(torch.int32)

    # --- 5. metric accumulation (int32, warmup-gated; `lost` ungated) ----
    g = 1 if cycle >= warmup else 0
    lost_c = lost_enq_row.sum(dim=1)
    acc_c = acc.sum(dim=1)
    hard_drop_c = drop_route.sum(dim=1) + lost_c
    if fault_drop is not None:
        hard_drop_c = hard_drop_c + fault_drop.sum(dim=1)
    if trace is None:
        offered_c = inj.sum(dim=1)
        dropped_c = (inj & ~room).sum(dim=1) + hard_drop_c
    else:
        # Trace semantics: a blocked injection retries next cycle, so
        # offered := accepted and back-pressure is not a drop; conservation
        # offered == delivered + dropped + in_flight stays exact.
        offered_c = acc_c
        dropped_c = hard_drop_c
    zero = torch.zeros_like(lost_c)
    m_scal = m_scal + torch.stack([
        g * delivered_c, g * offered_c, g * acc_c, g * dropped_c,
        lost_c + residue.sum(dim=1), g * lat_c, g * moved_c, zero],
        dim=1).to(torch.int32)
    if diagnostics:
        kind_oh = geom.kind[None, :] == idx.kinds8              # [8, L+1]
        stalled = contend & ~winner
        stall_kind = geom.kind[nxt_cl]                          # [B, L+1]
        wins = g * (kind_oh[None] & winner[:, None, :]).sum(dim=2)
        stalls = g * ((stall_kind[:, None, :] == idx.kinds8[None])
                      & stalled[:, None, :]).sum(dim=2)
        m_kind = m_kind + torch.stack(
            [wins, stalls, torch.zeros_like(wins)], dim=1).to(torch.int32)
    if trace is None:
        return (q_pack, q_len, wait, m_scal, m_kind), passes

    # --- 6. phase barrier (trace mode) -----------------------------------
    # A flit retires when it delivers or (unless strict_barrier) is
    # dropped or lost; the phase completes once all its flits retired.  The
    # cursor advances at the END of the cycle, so phase i+1 first injects
    # at cycle+1 — strictly after phase i's last delivery (ph_done[i]).
    sent = sent + acc.to(torch.int32)
    if len(trace) > 3:
        rec = rec + (acc & (sent == rec_end_now)).to(torch.int32)
    retired_c = delivered_c if strict_barrier else delivered_c + hard_drop_c
    credit = credit + retired_c.to(torch.int32)
    cur_total = ph_total[batch_ids, cur]
    done_now = active & (credit >= cur_total)
    at_cur = torch.arange(n_phases, device=cur.device)[None, :] == cur[:, None]
    ph_done = torch.where(done_now[:, None] & at_cur, cycle, ph_done)
    ph_idx = ph_idx + done_now.to(torch.int32)
    sent = torch.where(done_now[:, None], 0, sent)
    credit = torch.where(done_now, 0, credit)
    if watchdog:
        # Progress = the active phase retired credit, accepted an
        # injection, or moved a flit (congestion is not a stall).
        progress = (retired_c > 0) | (acc_c > 0) | (moved_c > 0)
        stall = torch.where(active & ~done_now & ~progress, stall + 1, 0)
        fire = active & ~done_now & (stall >= watchdog)
        # The stalled phase records -2 - cycle, the unretired credit lands
        # in STALL_CREDIT, and the cursor jumps past the end.
        ph_done = torch.where(fire[:, None] & at_cur, -2 - cycle, ph_done)
        m_scal[:, STALL_CREDIT] += (fire.to(torch.int32)
                                    * (cur_total - credit))
        ph_idx = torch.where(fire, n_phases, ph_idx)
    state = (q_pack, q_len, wait, m_scal, m_kind,
             ph_idx, sent, credit, ph_done, stall)
    if len(trace) > 3:
        # The next phase's first records, for the PEs whose phase closed.
        nxt_ph = ph_idx.clamp(0, n_phases - 1).long()
        state += (torch.where(done_now[:, None], rec_start[batch_ids, nxt_ph],
                              rec),)
    return state, passes


def run_plain(geom, inj_s: torch.Tensor, dst_s: torch.Tensor, *,
              warmup: int, starvation_limit: int, arb_iters: int,
              trace=None, faults=None, fault_u: torch.Tensor | None = None,
              strict_barrier: bool = False, watchdog: int = 0,
              diagnostics: bool = False):
    """The plain twin of ``run_fused``: ``cycle_step`` looped over the
    cycles.  ``inj_s`` is [B, cycles, P] bool and ``dst_s`` [B, cycles, P]
    int16; ``trace`` (a triple, or six tables in records form) and
    ``faults`` (a triple) are ``cycle_step``'s, and
    ``fault_u`` the [B, cycles, F] float32 stream.  Returns ``(q_len
    [B, L+1], m_scal [B, 8], m_kind [B, 3, 8], passes [B], ph_done
    [B, n_phases])`` int32; ``n_phases`` is 0 for statistical traffic."""
    batch, cycles, p_pes = inj_s.shape
    lp1 = geom.route.shape[0]
    n_phases = 0 if trace is None else trace[0].shape[1]
    state = initial_state(
        batch, lp1 - 1, geom.depth, inj_s.device, n_pes=p_pes,
        n_phases=n_phases,
        rec_start=trace[3] if trace is not None and len(trace) > 3 else None)
    idx = index_tables(geom, geom.depth)
    passes = torch.zeros(batch, dtype=torch.int32, device=inj_s.device)
    for c in range(cycles):
        state, p = cycle_step(
            geom, state, c, inj_s[:, c], dst_s[:, c],
            None if faults is None else fault_u[:, c], warmup=warmup,
            starvation_limit=starvation_limit, arb_iters=arb_iters,
            trace=trace, faults=faults, strict_barrier=strict_barrier,
            watchdog=watchdog, diagnostics=diagnostics, idx=idx)
        passes += p
    ph_done = (state[8] if trace is not None else torch.zeros(
        (batch, 0), dtype=torch.int32, device=inj_s.device))
    return state[1], state[3], state[4], passes, ph_done


# ---------------------------------------------------------------------------
# The CUDA kernel: built from csrc/noc_step.cu at first use.
# ---------------------------------------------------------------------------
THREADS = 1024
# Shared memory a block may opt in to on the H100 (227 KB), and the
# largest portable thread-block cluster.
SHARED_LIMIT_BYTES = 232_448
MAX_CLUSTER = 8
# Words of the kernel's per-CTA control block (counters, metric partials,
# fixpoint flags, trace barrier state, the active-row count, the two
# int64 clocks of the barrier waits and the cycle loop):
# csrc/noc_step.cu's CTL_WORDS.
CTL_WORDS = 88


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def shared_bytes(rows: int, chans: int, depth: int, P: int, F: int,
                 n_phases: int, records: bool = False) -> int:
    """Bytes of one CTA's shared memory holding ``rows`` queue rows and
    ``chans`` output channels: the layout of ``carve`` in
    csrc/noc_step.cu, each array rounded up to 16 bytes.  int32: the
    packed queue words, the pre-move heads (two slots), the scores, each
    row's incoming sender, the target queue's score, the channel maxima
    (three slots), trace mode's per-PE sent counts (and after them, in
    records form, the record cursors), the four fault-entry columns,
    ph_total and ph_done, the control block.  16-bit: nxt, the
    channel each head targets, wait, phys, prio, inj_pe, the list of
    active rows, the target queue's channel, the cycle's destination, the
    row's id in the geometry's order.  Bytes: q_len, cap, kind with
    is_sink and the candidate bit, the target queue's free slots, the
    queue's ring head, the cycle's injection, and the flags (active, win,
    feas; two slots)."""
    i32 = (rows * depth, 2 * rows, rows, rows, rows, 3 * chans,
           (2 if records else 1) * P if n_phases > 0 else 0, F, F, F, F,
           n_phases, n_phases, CTL_WORDS)
    return (sum(_a16(4 * n) for n in i32) + 10 * _a16(2 * rows)
            + 6 * _a16(rows) + _a16(2 * rows))


def cluster_plan(L1: int, NP1: int, depth: int, P: int, F: int,
                 n_phases: int, *, records: bool = False,
                 cluster: int | None = None) -> tuple[int, int]:
    """``(C, shared_bytes)``: the smallest cluster of C <= 8 CTAs whose
    per-CTA slice (``ceil(L1 / C)`` queue rows, ``ceil(NP1 / C)`` output
    channels, the ``F`` fault entries, ``n_phases`` trace phases and, in
    records form, the record cursors) fits ``SHARED_LIMIT_BYTES``, and
    that slice's bytes.  ``cluster`` asks for one size (it must fit).
    Raises ``ValueError`` when nothing fits."""
    sizes = range(1, MAX_CLUSTER + 1) if cluster is None else (cluster,)
    for c in sizes:
        if not 1 <= c <= MAX_CLUSTER:
            raise ValueError(f"cluster size must be 1..{MAX_CLUSTER}, "
                             f"got {c}")
        nbytes = shared_bytes(-(-L1 // c), -(-NP1 // c), depth, P, F,
                              n_phases, records)
        if nbytes <= SHARED_LIMIT_BYTES:
            return c, nbytes
    raise ValueError(
        f"a geometry of {L1} queue rows and {NP1} channels (depth {depth}, "
        f"{F} fault entries, {n_phases} trace phases) needs more than "
        f"{SHARED_LIMIT_BYTES} bytes of shared memory per CTA even at "
        f"cluster size {sizes[-1]}")


def locality_order(geom) -> tuple[np.ndarray, np.ndarray]:
    """Orders of the queue rows and output channels that keep a node's
    queues together and neighbouring nodes close: ``(rows, chans)``, each
    a permutation that leaves the dummy row / channel last.

    A node is a bucket of the fan-in tables (the queues arriving at it); a
    row belongs to its destination node (its next hops leave from there),
    else its source node; a channel to its source node, where the rows
    that contend for it arrive.  Nodes are numbered breadth-first from a
    least-connected one, neighbours by degree (Cuthill-McKee), so a
    contiguous split of the rows is a compact patch of the fabric."""
    cand, intab = geom.cand.cpu().numpy(), geom.intab.cpu().numpy()
    phys = geom.phys.cpu().numpy()
    lp1, np1 = intab.shape[0], cand.shape[0]
    pad = lp1 - 1
    keys: dict = {}

    def bucket(row) -> int:
        k = tuple(int(q) for q in row if q != pad)
        return keys.setdefault(k, len(keys)) if k else -1
    chan_node = np.array([bucket(cand[c]) for c in range(np1)])
    dst_node = np.full(lp1, -1)
    for c in range(np1):
        for q in cand[c]:
            if q != pad:
                dst_node[q] = chan_node[c]
    src_node = np.array([bucket(intab[q]) for q in range(lp1)])
    adj: list[set] = [set() for _ in keys]
    for a, b in zip(src_node[:-1], dst_node[:-1]):
        if a >= 0 and b >= 0 and a != b:
            adj[a].add(b)
            adj[b].add(a)
    degree = [len(x) for x in adj]
    seen = [False] * len(adj)
    visit = []
    for start in sorted(range(len(adj)), key=degree.__getitem__):
        if not seen[start]:
            seen[start] = True
            queue = collections.deque([start])
            while queue:
                u = queue.popleft()
                visit.append(u)
                for v in sorted(adj[u], key=degree.__getitem__):
                    if not seen[v]:
                        seen[v] = True
                        queue.append(v)
    rank = np.empty(len(adj) + 2, np.int64)
    rank[visit] = np.arange(len(visit))
    rank[-2:] = len(visit), len(visit) + 1   # no node, then the dummy
    row_node = np.where(dst_node >= 0, dst_node, src_node)
    row_node[pad] = -1
    row_key = rank[np.where(row_node >= 0, row_node, -2)]
    row_key[pad] = rank[-1]
    for q in range(pad):
        if chan_node[phys[q]] < 0:       # a channel nothing arrives for
            chan_node[phys[q]] = row_node[q]
    chan_key = rank[np.where(chan_node >= 0, chan_node, -2)]
    chan_key[np1 - 1] = rank[-1]
    return (np.lexsort((np.arange(lp1), row_key)),
            np.lexsort((np.arange(np1), chan_key)))


def remote_share(geom, cluster: int) -> dict:
    """The share of the live route hops (a row, the next queue of its
    head) whose accesses cross CTAs in the kernel's layout at cluster size
    ``cluster``: ``channel`` when the row's target channel (whose maximum
    it raises and reads) sits in another CTA, ``next_row`` when the next
    queue (whose flags, maximum and sender slot it reads or raises) does."""
    lay = layout(geom, cluster)
    lp1, np1 = geom.n_links + 1, geom.n_phys + 1
    route = lay.route.cpu().numpy().astype(np.int64)[:-1]   # kernel order
    live = route >= 0
    hop = np.clip(route, 0, lp1 - 1)
    own = np.arange(lp1 - 1)[:, None] // -(-lp1 // cluster)
    chan = lay.phys.cpu().numpy()[hop] // -(-np1 // cluster)

    def share(remote) -> float:
        return float(remote[live].mean()) if live.any() else 0.0
    return {"channel": share(chan != own),
            "next_row": share(hop // -(-lp1 // cluster) != own)}


class Layout(NamedTuple):
    """The kernel's view of a geometry, on its device: the static tables in
    the kernel's row and channel order (each permuted, ids renumbered), the
    original id of each row (``orig``) and the route table in that order
    (its rows, and the ids it holds; -1 stays -1).  ``rows`` / ``row_at``
    (int64) map kernel positions to geometry rows and back; None when the
    order is the geometry's own, whose route is ``geom.route`` itself."""

    kind: torch.Tensor
    prio: torch.Tensor
    cap: torch.Tensor
    phys: torch.Tensor
    is_sink: torch.Tensor
    inj_pe: torch.Tensor
    contends: torch.Tensor
    orig: torch.Tensor
    rows: torch.Tensor | None
    row_at: torch.Tensor | None
    route: torch.Tensor | None = None


# The geometry's static tables: ``core.sim.GEOMETRY_ARRAYS`` but the route.
_STATIC = ("kind", "prio", "cap", "phys", "is_sink", "pe_src_link", "inj_pe",
           "cand", "intab")


def layout(geom, cluster: int) -> Layout:
    """The kernel's view of ``geom``: the geometry's own order at C = 1,
    ``locality_order`` above it (so fewer accesses cross CTAs).  Checked
    and built once per order and kept in ``geom.kernel``, which
    ``core.sim.build_geometry`` shares among a fabric's geometries on a
    device: the static part while the geometry holds the tensors (and
    depth) it came from, the route beside it while ``geom.route`` does, so
    a new route array on the same fabric reuses the static part."""
    local = cluster > 1
    static = _kept(geom, local,
                   [geom.depth, *(getattr(geom, k) for k in _STATIC)],
                   lambda: _static_view(geom, local))
    return _kept(geom, (local, "route"), [geom.route, static],
                 lambda: static._replace(route=_kernel_route(geom, static)))


def _kept(geom, key, sources: list, build):
    """``geom.kernel[key]`` while it was built from these very objects,
    tensors unwritten since (a write in place moves a tensor's version);
    else ``build()``, kept in its place."""
    now = [(x, getattr(x, "_version", None)) for x in sources]
    held = geom.kernel.get(key)
    if held is None or any(a is not b or u != v
                           for (a, u), (b, v) in zip(held[0], now)):
        held = geom.kernel[key] = (now, build())
    return held[1]


def _static_view(geom, local: bool) -> Layout:
    _check_geometry(geom)
    dev, lp1 = geom.cand.device, geom.n_links + 1
    cont = torch.zeros(lp1, dtype=torch.uint8, device=dev)
    cont[geom.cand.reshape(-1).long()] = 1
    cont[lp1 - 1] = 0
    if not local:
        return Layout(geom.kind, geom.prio, geom.cap, geom.phys,
                      geom.is_sink, geom.inj_pe, cont,
                      torch.arange(lp1, dtype=torch.int16, device=dev),
                      None, None)
    order, chan_order = locality_order(geom)
    rows = torch.from_numpy(order).to(dev)
    row_at = torch.empty_like(rows)
    row_at[rows] = torch.arange(lp1, device=dev)
    chan_at = torch.empty(len(chan_order), dtype=torch.int64, device=dev)
    chan_at[torch.from_numpy(chan_order).to(dev)] = torch.arange(
        len(chan_order), device=dev)
    return Layout(geom.kind[rows].contiguous(), geom.prio[rows].contiguous(),
                  geom.cap[rows].contiguous(),
                  chan_at[geom.phys[rows].long()].to(torch.int32),
                  geom.is_sink[rows].contiguous(),
                  geom.inj_pe[rows].contiguous(), cont[rows].contiguous(),
                  rows.to(torch.int16), rows, row_at)


def _kernel_route(geom, static: Layout) -> torch.Tensor:
    _check_tensor("geometry field 'route'", geom.route, torch.int16,
                  (geom.n_links + 1, geom.n_pes), geom.cand.device)
    if static.rows is None:
        return geom.route
    # Each id's kernel position, and -1 (INVALID) at index -1.
    at = torch.cat([static.row_at, static.row_at.new_full((1,), -1)])
    return at.to(torch.int16)[geom.route[static.rows].long()]


def _configure(lib: ctypes.CDLL) -> None:
    lib.noc_step_launch.restype = ctypes.c_int
    lib.noc_step_launch.argtypes = ([ctypes.c_void_p] * 27
                                    + [ctypes.c_int] * 17
                                    + [ctypes.c_void_p])
    lib.noc_step_shared_bytes.restype = ctypes.c_longlong
    lib.noc_step_shared_bytes.argtypes = [ctypes.c_int] * 7
    lib.noc_step_max_active_clusters.restype = ctypes.c_int
    lib.noc_step_max_active_clusters.argtypes = [
        ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
    lib.noc_step_barrier_probe.restype = ctypes.c_int
    lib.noc_step_barrier_probe.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]


LIBRARY = build.Library("noc_step", _configure,
                        error_fn="noc_step_error_string")


def load_library() -> ctypes.CDLL:
    """Compile ``csrc/noc_step.cu`` (once per source version) into
    ``build/torch_kernels/`` and load it."""
    return LIBRARY.load()


def kernel_shared_bytes(rows: int, chans: int, depth: int, P: int, F: int,
                        n_phases: int, records: bool = False) -> int:
    """The kernel's own count of ``shared_bytes`` (its ``carve``)."""
    return int(load_library().noc_step_shared_bytes(
        rows, chans, depth, P, F, n_phases, 1 if records else 0))


def max_active_clusters(cluster: int, nbytes: int) -> int:
    """How many clusters of ``cluster`` CTAs with ``nbytes`` of shared
    memory each the current card can hold at once."""
    lib = load_library()
    err = ctypes.c_int(0)
    n = lib.noc_step_max_active_clusters(cluster, nbytes, ctypes.byref(err))
    LIBRARY.check(err.value)
    return n


def barrier_cost(cluster: int, threads: int = THREADS,
                 iters: int = 20_000) -> dict:
    """The cost of one of the kernel's barriers at cluster size
    ``cluster`` (a block barrier at 1) over ``threads`` threads per CTA:
    device ns per barrier from CUDA events around one launch of ``iters``
    barriers, and the SM cycles per barrier that clock64() counted on the
    slowest CTA."""
    lib = load_library()
    cycles = torch.zeros(cluster, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    start, stop = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
    LIBRARY.check(lib.noc_step_barrier_probe(cluster, threads, 100,
                                             cycles.data_ptr(), stream))
    start.record()
    LIBRARY.check(lib.noc_step_barrier_probe(cluster, threads, iters,
                                             cycles.data_ptr(), stream))
    stop.record()
    torch.cuda.synchronize()
    return {"ns": start.elapsed_time(stop) * 1e6 / iters,
            "cycles": float(cycles.max()) / iters}


def _check_tensor(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _check_geometry(geom) -> None:
    """Refuse static tables the kernel cannot take: dtypes, shapes and one
    device, and what its narrowed rows would not hold exactly (q_len and
    cap in a byte, prio, phys, inj_pe and queue ids in 16 bits)."""
    lp1, np1, dev = geom.n_links + 1, geom.n_phys + 1, geom.cand.device
    for name in _STATIC:
        t = getattr(geom, name)
        shape = {"pe_src_link": (geom.n_pes,), "cand": (np1, t.shape[-1]),
                 "intab": (lp1, t.shape[-1])}.get(name, (lp1,))
        _check_tensor(f"geometry field {name!r}", t, torch.bool
                      if name == "is_sink" else torch.int32, shape, dev)
    if lp1 > 0x7FFF or np1 > 0x7FFF or geom.depth > 254:
        raise ValueError(f"the kernel takes < 32768 queue rows and channels "
                         f"and depth <= 254, got {lp1}, {np1}, "
                         f"{geom.depth}")
    # Rows over capacity 254 (the unbounded ejection queues) must never
    # hold a flit: sinks that are not inject queues.  The dummy row is
    # exempt (nothing routes into it).
    big = geom.cap[:-1] > 254
    bad = torch.stack([
        (big & (~geom.is_sink[:-1] | (geom.inj_pe[:-1] >= 0))).any(),
        (geom.prio < -0x8000).any() | (geom.prio > 0x7FFF).any(),
        (geom.cap < 0).any()]).tolist()
    if any(bad):
        raise ValueError(
            "geometry does not fit the kernel's narrowed rows: "
            + str(dict(zip(("unbounded queue that holds flits",
                            "prio outside int16", "negative capacity"),
                           bad))))


def _check_launch(geom, inj_s: torch.Tensor, dst_s: torch.Tensor,
                  starvation_limit: int, trace=None, faults=None,
                  fault_u=None) -> None:
    """Refuse a launch's own operands: the streams, the trace and fault
    tables, and ``starvation_limit`` (the kernel saturates wait in 16
    bits).  The geometry's tables are ``layout``'s to check."""
    dev, p_pes = inj_s.device, geom.n_pes
    if not 0 <= starvation_limit <= 0xFFFF:
        raise ValueError(f"starvation_limit must be in [0, 65535] for the "
                         f"kernel, got {starvation_limit}")
    if (inj_s.dtype != torch.bool or dst_s.dtype != torch.int16
            or dst_s.device != dev or geom.cand.device != dev
            or inj_s.dim() != 3
            or dst_s.shape != inj_s.shape or inj_s.shape[2] != p_pes
            or not inj_s.is_contiguous() or not dst_s.is_contiguous()):
        raise ValueError(
            "streams must be contiguous [B, cycles, P] tensors on the "
            f"geometry's device: inj bool, dst int16; got "
            f"{tuple(inj_s.shape)} {inj_s.dtype} and {tuple(dst_s.shape)} "
            f"{dst_s.dtype} on {dev}")
    batch, cycles = inj_s.shape[:2]
    want = []  # (name, tensor, dtype, shape)
    if trace is not None:
        n_phases = trace[0].shape[1] if trace[0].dim() == 3 else 0
        records = len(trace) == 6
        n_rec = trace[4].shape[1] if records and trace[4].dim() == 2 else 0
        if (n_phases < 1 or len(trace) not in (3, 6)
                or (records and n_rec < 1)):
            raise ValueError("trace must be (ph_dst, ph_flits, ph_total) "
                             "[B, n_phases >= 1, P] / [B, n_phases], and "
                             "in records form (rec_start, rec_dst, rec_end) "
                             "[B, n_phases, P] / [B, R >= 1]")
        ph, rec = (batch, n_phases, p_pes), (batch, n_rec)
        want += [(n, t, torch.int32, sh) for n, t, sh in zip(
            ("ph_dst", "ph_flits", "ph_total", "rec_start", "rec_dst",
             "rec_end"), trace, (ph, ph, ph[:2], ph, rec, rec))]
    if faults is not None:
        n_faults = faults[0].shape[1] if faults[0].dim() == 2 else 0
        if n_faults < 1 or fault_u is None:
            raise ValueError("faults need [B, F >= 1] entries and the "
                             "[B, cycles, F] fault_u stream")
        want += zip(("fault links", "fault drop_p", "fault onset", "fault_u"),
                    (*faults, fault_u), (torch.int32, torch.float32,
                                         torch.int32, torch.float32),
                    ((batch, n_faults),) * 3 + ((batch, cycles, n_faults),))
    for name, t, dtype, shape in want:
        _check_tensor(name, t, dtype, shape, dev)


def plan_for(geom, trace=None, faults=None,
             cluster: int | None = None) -> tuple[int, int]:
    """``cluster_plan`` for a launch on ``geom`` with these operands."""
    return cluster_plan(
        geom.route.shape[0], geom.cand.shape[0], geom.depth,
        geom.route.shape[1], 0 if faults is None else faults[0].shape[1],
        0 if trace is None else trace[0].shape[1],
        records=trace is not None and len(trace) > 3, cluster=cluster)


@telemetry.spanned("noc_step.run_fused")
def run_fused(geom, inj_s: torch.Tensor, dst_s: torch.Tensor, *,
              warmup: int, starvation_limit: int, arb_iters: int,
              trace=None, faults=None, fault_u: torch.Tensor | None = None,
              strict_barrier: bool = False, watchdog: int = 0,
              diagnostics: bool = False, cluster_size: int | None = None):
    """Run every cycle of a batch of points as one kernel launch.

    Same contract as ``run_plain``, on CUDA tensors only: the kernel (one
    cluster of ``cluster_plan``'s C CTAs per point) is launched on the
    current stream.  Trace replay and faults pick the kernel's
    compile-time modes.  ``cluster_size`` forces C (tests use it to run a
    small geometry across a cluster; the simulator never passes it).  The
    kernel relies on each PE's inject queue being the one row whose
    ``inj_pe`` names that PE, which ``core.sim`` checks when it builds a
    geometry, and on the structural fan-in tables (every route hop is
    node-local, and ``cand`` / ``intab`` list every queue arriving at a
    node; ``core.sim`` asserts the first for every route table it builds):
    the kernel scatters where the twin gathers over those tables.

    Each launch adds to its modes' ``noc_step.launches[...]`` counters.
    While telemetry is on, the launch runs the kernel with its counters
    (SM cycles of each CTA's barrier waits and of its whole cycle loop, a
    [B, C, 2] int64 buffer) and keeps them as a ``noc_step.clock`` kernel
    record; the host work before the launch is the ``noc_step.prepare``
    span: the launch's own checks and buffers, and ``layout`` (built at a
    geometry's first launch).  Nothing is read back before the launch.
    """
    with telemetry.span("noc_step.prepare"):
        dev = inj_s.device
        if dev.type != "cuda":
            raise ValueError(
                f"run_fused launches the CUDA kernel and takes CUDA tensors, "
                f"got {dev}; run_plain runs the plain twin on any device")
        _check_launch(geom, inj_s, dst_s, starvation_limit, trace, faults,
                      fault_u)
        cluster, _ = plan_for(geom, trace, faults, cluster_size)
        lay = layout(geom, cluster)
        batch, cycles, p_pes = inj_s.shape
        lp1, np1 = geom.n_links + 1, geom.n_phys + 1
        n_phases = 0 if trace is None else trace[0].shape[1]
        n_faults = 0 if faults is None else faults[0].shape[1]
        lib = load_library()
        i32 = dict(dtype=torch.int32, device=dev)
        q_len = torch.empty((batch, lp1), **i32)
        m_scal = torch.empty((batch, N_SCALARS), **i32)
        m_kind = torch.empty((batch, N_KIND_ROWS, 8), **i32)
        passes = torch.empty((batch,), **i32)
        ph_done = torch.empty((batch, n_phases), **i32)
        if faults is not None and lay.rows is not None:
            # The fault entries' queue ids in the kernel's order.
            faults = (lay.row_at[faults[0].long()].to(torch.int32),
                      *faults[1:])
        # The phase tables, then the record tables (null where absent).
        tabs = list(trace or ()) + [None] * (6 - len(trace or ()))
        t_ptrs = [0 if t is None else t.data_ptr() for t in tabs]
        n_rec = 0 if tabs[4] is None else tabs[4].shape[1]
        f_ptrs = (0, 0, 0, 0) if faults is None else (
            fault_u.data_ptr(), *(t.data_ptr() for t in faults))
        # The kernel's barrier-wait and cycle-loop clocks of each CTA, only
        # while telemetry is on (a null pointer turns them off).
        clock = (torch.empty((batch, cluster, 2), dtype=torch.int64,
                             device=dev) if telemetry.is_on() else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.noc_step_launch(
        inj_s.data_ptr(), dst_s.data_ptr(), lay.route.data_ptr(),
        lay.kind.data_ptr(), lay.prio.data_ptr(), lay.cap.data_ptr(),
        lay.phys.data_ptr(), lay.is_sink.data_ptr(),
        lay.inj_pe.data_ptr(), lay.contends.data_ptr(), lay.orig.data_ptr(),
        q_len.data_ptr(), m_scal.data_ptr(), m_kind.data_ptr(),
        passes.data_ptr(), *t_ptrs[:3], ph_done.data_ptr(), *t_ptrs[3:],
        *f_ptrs,
        0 if clock is None else clock.data_ptr(), batch, lp1, p_pes, np1,
        geom.depth, cycles, warmup, starvation_limit, arb_iters,
        1 if diagnostics else 0, score_pow2(lp1), n_phases,
        1 if strict_barrier else 0, watchdog, n_faults, n_rec, cluster,
        stream)
    LIBRARY.check(err)
    for mode in launch_modes(trace, faults):
        telemetry.count(LAUNCH_COUNTERS[mode])
    telemetry.kernel("noc_step.clock", cluster=cluster, cycles=cycles,
                     clock=clock)
    if lay.rows is not None:
        q_len = q_len[:, lay.row_at]
    return q_len, m_scal, m_kind, passes, ph_done
