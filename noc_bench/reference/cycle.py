"""The cycle loop of the NoC simulator in plain torch, frozen from the port.

``cycle_step`` is one cycle for a batch of points (route, arbitrate with
the early-exit fixpoint, move, inject, count), and ``run_plain`` loops it
over the cycles.  ``build_geometry`` prepares the topology's tables for it.
Every accumulator is int32.  It runs on any device and calls no kernel of
the program under test.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import topology as topo_mod

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
        col_k=torch.arange(depth, **i32)[None, None, :])


def initial_state(batch: int, n_links: int, depth: int, device, *,
                  n_pes: int = 0, n_phases: int = 0):
    """Zeroed carry: (packed queue words [B, L+1, depth], queue lengths
    [B, L+1], aging counters [B, L+1], scalar metrics [B, 8], per-kind
    metrics [B, 3, 8]), all int32.  With ``n_phases > 0`` (trace replay)
    the carry extends to the 10-tuple: + (phase cursor [B], per-PE flits
    sent [B, P], retired-flit credit [B], per-phase completion cycles
    [B, n_phases] initialized -1, stall-watchdog counter [B])."""
    z = dict(dtype=torch.int32, device=device)
    base = (torch.zeros((batch, n_links + 1, depth), **z),
            torch.zeros((batch, n_links + 1), **z),
            torch.zeros((batch, n_links + 1), **z),
            torch.zeros((batch, N_SCALARS), **z),
            torch.zeros((batch, N_KIND_ROWS, 8), **z))
    if n_phases <= 0:
        return base
    return base + (torch.zeros((batch,), **z),
                   torch.zeros((batch, n_pes), **z),
                   torch.zeros((batch,), **z),
                   torch.full((batch, n_phases), -1, **z),
                   torch.zeros((batch,), **z))


def score_pow2(n_rows: int) -> int:
    """Round-robin modulus: the power of two at or above ``L+1``, which
    keeps every queue's arbitration score unique."""
    return 1 << int(math.ceil(math.log2(n_rows)))


def cycle_step(geom, state, cycle: int, inj: torch.Tensor,
               dst: torch.Tensor, fault_u: torch.Tensor | None = None, *,
               warmup: int, starvation_limit: int, arb_iters: int,
               trace=None, faults=None, strict_barrier: bool = False,
               watchdog: int = 0,
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
         ph_idx, sent, credit, ph_done, stall) = state
        ph_dst, ph_flits, ph_total = trace
        n_phases = ph_dst.shape[1]
        batch_ids = torch.arange(ph_idx.shape[0], device=ph_idx.device)
        # The cursor is clipped for the gathers; `active` reads it unclipped.
        cur = ph_idx.clamp(0, n_phases - 1).long()
        active = ph_idx < n_phases
        cur_flits = ph_flits[batch_ids, cur]                  # [B, P]
        # The Bernoulli row throttles bandwidth (inj_rate=1.0 -> inject as
        # fast as back-pressure allows); the phase gate does the rest.
        inj = inj & active[:, None] & (cur_flits - sent > 0)
        dst = ph_dst[batch_ids, cur]
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
    if trace is None:
        return (q_pack, q_len, wait, m_scal, m_kind), passes

    # --- 6. phase barrier (trace mode) -----------------------------------
    # A flit retires when it delivers or (unless strict_barrier) is
    # dropped or lost; the phase completes once all its flits retired.  The
    # cursor advances at the END of the cycle, so phase i+1 first injects
    # at cycle+1 — strictly after phase i's last delivery (ph_done[i]).
    sent = sent + acc.to(torch.int32)
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
    return ((q_pack, q_len, wait, m_scal, m_kind,
             ph_idx, sent, credit, ph_done, stall), passes)


def run_plain(geom, inj_s: torch.Tensor, dst_s: torch.Tensor, *,
              warmup: int, starvation_limit: int, arb_iters: int,
              trace=None, faults=None, fault_u: torch.Tensor | None = None,
              strict_barrier: bool = False, watchdog: int = 0):
    """``cycle_step`` looped over the cycles.  ``inj_s`` is [B, cycles, P] bool and ``dst_s`` [B, cycles, P]
    int16; ``trace`` and ``faults`` are ``cycle_step``'s triples and
    ``fault_u`` the [B, cycles, F] float32 stream.  Returns ``(q_len
    [B, L+1], m_scal [B, 8], m_kind [B, 3, 8], passes [B], ph_done
    [B, n_phases])`` int32; ``n_phases`` is 0 for statistical traffic."""
    batch, cycles, p_pes = inj_s.shape
    lp1 = geom.route.shape[0]
    n_phases = 0 if trace is None else trace[0].shape[1]
    state = initial_state(batch, lp1 - 1, geom.depth, inj_s.device,
                          n_pes=p_pes, n_phases=n_phases)
    idx = index_tables(geom, geom.depth)
    passes = torch.zeros(batch, dtype=torch.int32, device=inj_s.device)
    for c in range(cycles):
        state, p = cycle_step(
            geom, state, c, inj_s[:, c], dst_s[:, c],
            None if faults is None else fault_u[:, c], warmup=warmup,
            starvation_limit=starvation_limit, arb_iters=arb_iters,
            trace=trace, faults=faults, strict_barrier=strict_barrier,
            watchdog=watchdog, idx=idx)
        passes += p
        # A replay whose every phase is done and whose queues are empty
        # injects, moves and counts nothing more: each later cycle leaves
        # the outputs as they are and takes its one pass.
        if (trace is not None and c % 32 == 31
                and bool((state[5] >= n_phases).all())
                and not bool(state[1].any())):
            passes += cycles - 1 - c
            break
    ph_done = (state[8] if trace is not None else torch.zeros(
        (batch, 0), dtype=torch.int32, device=inj_s.device))
    return state[1], state[3], state[4], passes, ph_done


@dataclasses.dataclass(frozen=True, eq=False)
class Geometry:
    """Device-ready topology view, on one device.

    ``cand``/``intab`` are *structural* fan-in tables: queue q can only
    ever receive a flit from a queue whose destination node is q's source
    node, so they are supersets of any route table's live edges and stay
    valid across morphs.  Runtime masks select the live subset.
    """
    route: torch.Tensor      # [L+1, P] int16 (re-read per call: morph-aware)
    kind: torch.Tensor       # [L+1] int32
    prio: torch.Tensor       # [L+1] int32
    cap: torch.Tensor        # [L+1] int32
    phys: torch.Tensor       # [L+1] int32 (dummy row -> n_phys)
    is_sink: torch.Tensor    # [L+1] bool
    pe_src_link: torch.Tensor  # [P] int32
    inj_pe: torch.Tensor     # [L+1] int32: PE injecting into this row, or -1
    cand: torch.Tensor       # [n_phys+1, Fc] int32 queue ids (pad = L)
    intab: torch.Tensor      # [L+1, Fi] int32 queue ids (pad = L)
    n_links: int
    n_phys: int
    n_pes: int
    depth: int
    cap_total: int           # sum of finite queue capacities (lat_sum bound)


GEOMETRY_ARRAYS = ("route", "kind", "prio", "cap", "phys", "is_sink",
                   "pe_src_link", "inj_pe", "cand", "intab")
_DTYPES = {"route": torch.int16, "is_sink": torch.bool}


def _check_inject_rows(inj_pe: np.ndarray, pe_src_link: np.ndarray) -> None:
    """The CUDA kernel writes each PE's injection into the one row whose
    ``inj_pe`` names that PE; hold the tables to that."""
    p = pe_src_link.shape[0]
    if (not np.array_equal(inj_pe[pe_src_link], np.arange(p))
            or int((inj_pe >= 0).sum()) != p):
        raise ValueError("inj_pe must map each PE's inject queue back to "
                         "that PE, and no other row to any PE")


def _upload(host: dict, device) -> dict:
    return {k: torch.tensor(v, dtype=_DTYPES.get(k, torch.int32),
                            device=device) for k, v in host.items()}


def _structural(topo: topo_mod.Topology) -> dict:
    """Route-independent host arrays of the topology."""
    L, P = topo.n_links, topo.n_pes
    assert L + 1 < (1 << 15), "int16 queue ids require < 32767 links"
    src = topo.link_src_node
    dst = topo.link_dst_node
    # Structural invariant behind the fan-in tables: every route hop is
    # node-local (next queue leaves the current queue's destination node).
    nxt = topo.route_table
    live = nxt >= 0
    src_of_nxt = src[np.clip(nxt, 0, L - 1)]
    assert np.all(src_of_nxt[live] == np.broadcast_to(dst[:, None],
                                                      nxt.shape)[live]), \
        "route table contains a non-node-local hop"

    n_nodes = int(max(src.max(), dst.max())) + 1
    dead = (topo.dead_queues if topo.dead_queues is not None
            else np.zeros(L, bool))
    buckets: list[list[int]] = [[] for _ in range(n_nodes)]
    for q in range(L):
        # Dead queues (repaired fabrics) leave the candidate tables: they
        # can never hold a flit, so they must never win arbitration.
        if dst[q] >= 0 and not dead[q]:
            buckets[dst[q]].append(q)
    fi = max((len(b) for b in buckets), default=1) or 1

    intab = np.full((L + 1, fi), L, np.int32)
    for q in range(L):
        if src[q] >= 0:
            b = buckets[src[q]]
            intab[q, :len(b)] = b
    cand = np.full((topo.n_phys + 1, fi), L, np.int32)
    phys = topo.link_phys
    for q in range(L):
        if src[q] >= 0:
            b = buckets[src[q]]
            cand[phys[q], :len(b)] = b

    inj_pe = np.full(L + 1, -1, np.int32)
    inj_pe[topo.pe_src_link] = np.arange(P, dtype=np.int32)
    _check_inject_rows(inj_pe, topo.pe_src_link)

    finite = topo.link_cap < (1 << 29)
    cache = dict(
        kind=np.concatenate([topo.link_kind.astype(np.int32), [0]]),
        prio=np.concatenate([topo.link_prio.astype(np.int32), [0]]),
        cap=np.concatenate([topo.link_cap.astype(np.int32), [1 << 30]]),
        phys=np.concatenate([phys.astype(np.int32), [topo.n_phys]]),
        is_sink=np.concatenate([topo.is_sink, [False]]),
        pe_src_link=topo.pe_src_link.astype(np.int32),
        inj_pe=inj_pe, cand=cand, intab=intab,
        depth=int(topo.link_cap[finite].max()),
        cap_total=int(topo.link_cap[finite].sum()),
    )
    return cache


def build_geometry(topo: topo_mod.Topology, device="cuda") -> Geometry:
    """Device-ready geometry of ``topo`` on ``device``."""
    c = _structural(topo)
    dev = torch.device(device)
    static = _upload({k: c[k] for k in GEOMETRY_ARRAYS if k != "route"}, dev)
    route = np.concatenate(
        [topo.route_table.astype(np.int16),
         np.full((1, topo.n_pes), -1, np.int16)], axis=0)
    return Geometry(route=torch.from_numpy(route).to(dev), **static,
                    n_links=topo.n_links, n_phys=topo.n_phys,
                    n_pes=topo.n_pes, depth=c["depth"],
                    cap_total=c["cap_total"])
