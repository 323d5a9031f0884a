"""The NoC simulator's cycle loop: a plain PyTorch twin and a CUDA kernel.

``cycle_step`` is the step math of the reference's
``kernels/noc_step.py`` (route -> arbitrate -> move -> inject -> count) in
plain tensor code, with a leading batch dimension written out: every state
tensor is ``[B, ...]`` and the geometry is shared by the whole batch, which
is how ``core.sweep`` runs a grid of points on one topology.  ``run_plain``
loops it over cycles.  It is the oracle of the CUDA kernel.

``run_fused`` runs the whole cycle loop as one launch of the hand-written
kernel ``csrc/noc_step.cu`` (the port of the reference's Pallas
``_noc_step_kernel``): one thread block per sweep point, looping over the
cycles inside the kernel.  It takes CUDA tensors; given CPU tensors it runs
``run_plain`` instead, which is how the CPU tests reach it.  It never falls
back from a CUDA tensor to the twin: a missing compiler, a refused launch
or a fault raises.

Every accumulator is an int32, so the twin, the kernel and the reference
agree bit for bit; there is no reduction-order slack to allow for.  This
slice ports statistical traffic; the reference kernel's trace-replay and
fault-injection modes are later slices (ROADMAP Queue 2 item 1).
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from typing import NamedTuple

import torch

# Flat metric-accumulator layout shared by the twin and the kernel: slot
# names of the [N_SCALARS] int32 vector, then the rows of the
# [N_KIND_ROWS, 8] per-queue-kind table.  KIND_QLEN is filled by
# ``core.sim`` from the final queue lengths, not per cycle; STALL_CREDIT
# belongs to trace replay and stays 0 here.
(DELIVERED, OFFERED, ACCEPTED, DROPPED, LOST, LAT_SUM, MOVED,
 STALL_CREDIT) = range(8)
N_SCALARS = 8
KIND_WINS, KIND_STALLS, KIND_QLEN = range(3)
N_KIND_ROWS = 3

# Launches of the CUDA kernel since the last ``reset_launches()``.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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


def initial_state(batch: int, n_links: int, depth: int, device):
    """Zeroed carry: (packed queue words [B, L+1, depth], queue lengths
    [B, L+1], aging counters [B, L+1], scalar metrics [B, 8], per-kind
    metrics [B, 3, 8]), all int32."""
    z = dict(dtype=torch.int32, device=device)
    return (torch.zeros((batch, n_links + 1, depth), **z),
            torch.zeros((batch, n_links + 1), **z),
            torch.zeros((batch, n_links + 1), **z),
            torch.zeros((batch, N_SCALARS), **z),
            torch.zeros((batch, N_KIND_ROWS, 8), **z))


def score_pow2(n_rows: int) -> int:
    """Round-robin modulus: the power of two at or above ``L+1``, which
    keeps every queue's arbitration score unique."""
    return 1 << int(math.ceil(math.log2(n_rows)))


def cycle_step(geom, state, cycle: int, inj: torch.Tensor,
               dst: torch.Tensor, *, warmup: int, starvation_limit: int,
               arb_iters: int, diagnostics: bool = False,
               idx: IndexTables | None = None):
    """One simulator cycle for a batch of points.

    ``inj`` is the [B, P] bool injection row and ``dst`` the [B, P] int16
    destination row of this cycle.  Returns ``(state, passes)``: the new
    state tuple and the [B] int32 count of arbitration passes each point
    needed (the first select plus one per re-arbitration).  The model and
    its order of updates are the reference's, line for line; comments mark
    where a torch idiom replaces a JAX one.
    """
    q_pack, q_len, wait, m_scal, m_kind = state
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
    active = contend
    winner = select(active)
    feas_w = feasible(winner)
    passes = torch.ones(q_len.shape[0], dtype=torch.int32,
                        device=q_len.device)
    for _ in range(arb_iters - 1):
        bad = (winner & ~feas_w).any(dim=1)
        if not bool(bad.any()):
            break
        passes += bad.to(torch.int32)
        active = active & (~winner | feas_w)
        winner = select(active)
        feas_w = feasible(winner)
    residue = winner & ~feas_w
    winner = winner & ~residue

    deq = winner | drop_route
    sink = geom.is_sink[nxt_cl]
    send = winner & ~sink

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

    deliver = winner & sink
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
    offered_c = inj.sum(dim=1)
    dropped_c = (inj & ~room).sum(dim=1) + hard_drop_c
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
    return (q_pack, q_len, wait, m_scal, m_kind), passes


def run_plain(geom, inj_s: torch.Tensor, dst_s: torch.Tensor, *,
              warmup: int, starvation_limit: int, arb_iters: int,
              diagnostics: bool = False):
    """The plain twin of ``run_fused``: ``cycle_step`` looped over the
    cycles.  ``inj_s`` is [B, cycles, P] bool and ``dst_s`` [B, cycles, P]
    int16.  Returns ``(q_len [B, L+1], m_scal [B, 8], m_kind [B, 3, 8],
    passes [B])`` int32."""
    batch, cycles, _ = inj_s.shape
    lp1 = geom.route.shape[0]
    state = initial_state(batch, lp1 - 1, geom.depth, inj_s.device)
    idx = index_tables(geom, geom.depth)
    passes = torch.zeros(batch, dtype=torch.int32, device=inj_s.device)
    for c in range(cycles):
        state, p = cycle_step(geom, state, c, inj_s[:, c], dst_s[:, c],
                              warmup=warmup,
                              starvation_limit=starvation_limit,
                              arb_iters=arb_iters, diagnostics=diagnostics,
                              idx=idx)
        passes += p
    return state[1], state[3], state[4], passes


# ---------------------------------------------------------------------------
# The CUDA kernel: built from csrc/noc_step.cu at first use.
# ---------------------------------------------------------------------------
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                     "noc_step.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, os.pardir, os.pardir, "build",
                          "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
THREADS = 1024
_LIB = None
_LIB_LOCK = threading.Lock()
# nvcc's output of the last build (ptxas register and spill report).
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "the noc_step CUDA kernel is built at first use and needs "
            "nvcc (the CUDA toolkit); none was found")
    return path


def load_library() -> ctypes.CDLL:
    """Compile ``csrc/noc_step.cu`` (once per source version) into
    ``build/torch_kernels/`` and load it."""
    global _LIB, build_log
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        with open(_CSRC, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
        build_dir = os.path.normpath(_BUILD_DIR)
        os.makedirs(build_dir, exist_ok=True)
        so = os.path.join(build_dir, f"libnoc_step-{digest}.so")
        if not os.path.exists(so):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _CSRC],
                                  capture_output=True, text=True)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed on {_CSRC}:\n{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.noc_step_launch.restype = ctypes.c_int
        lib.noc_step_launch.argtypes = ([ctypes.c_void_p] * 17
                                        + [ctypes.c_int] * 14
                                        + [ctypes.c_void_p])
        lib.noc_step_error_string.restype = ctypes.c_char_p
        lib.noc_step_error_string.argtypes = [ctypes.c_int]
        lib.noc_step_workspace_words.restype = ctypes.c_longlong
        lib.noc_step_workspace_words.argtypes = [ctypes.c_int] * 3
        _LIB = lib
        return lib


_GEOM_FIELDS = {"route": torch.int16, "kind": torch.int32,
                "prio": torch.int32, "cap": torch.int32,
                "phys": torch.int32, "is_sink": torch.bool,
                "pe_src_link": torch.int32, "inj_pe": torch.int32,
                "cand": torch.int32, "intab": torch.int32}


def _check_inputs(geom, inj_s: torch.Tensor, dst_s: torch.Tensor) -> None:
    dev = inj_s.device
    lp1, p_pes = geom.route.shape
    for name, dtype in _GEOM_FIELDS.items():
        t = getattr(geom, name)
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"geometry field {name!r} must be a contiguous {dtype} "
                f"tensor on {dev}, got {t.dtype} on {t.device}")
    if (inj_s.dtype != torch.bool or dst_s.dtype != torch.int16
            or dst_s.device != dev or inj_s.dim() != 3
            or dst_s.shape != inj_s.shape or inj_s.shape[2] != p_pes
            or not inj_s.is_contiguous() or not dst_s.is_contiguous()):
        raise ValueError(
            "streams must be contiguous [B, cycles, P] tensors on one "
            f"device: inj bool, dst int16; got {tuple(inj_s.shape)} "
            f"{inj_s.dtype} and {tuple(dst_s.shape)} {dst_s.dtype}")
    for name, n in (("kind", lp1), ("prio", lp1), ("cap", lp1),
                    ("phys", lp1), ("is_sink", lp1), ("inj_pe", lp1),
                    ("pe_src_link", p_pes)):
        if tuple(getattr(geom, name).shape) != (n,):
            raise ValueError(f"geometry field {name!r} must have shape "
                             f"({n},), got {tuple(getattr(geom, name).shape)}")
    if geom.intab.shape[0] != lp1 or geom.cand.dim() != 2:
        raise ValueError("cand must be [NP1, Fc] and intab [L+1, Fi]")


def run_fused(geom, inj_s: torch.Tensor, dst_s: torch.Tensor, *,
              warmup: int, starvation_limit: int, arb_iters: int,
              diagnostics: bool = False):
    """Run every cycle of a batch of points as one kernel launch.

    Same contract as ``run_plain``.  CUDA tensors go to the CUDA kernel
    (one thread block per point), launched on the current stream; CPU
    tensors run ``run_plain``.  The kernel relies on each PE's inject
    queue being the one row whose ``inj_pe`` names that PE, which
    ``core.sim`` checks when it builds a geometry.
    """
    global launches
    dev = inj_s.device
    if dev.type == "cpu":
        return run_plain(geom, inj_s, dst_s, warmup=warmup,
                         starvation_limit=starvation_limit,
                         arb_iters=arb_iters, diagnostics=diagnostics)
    if dev.type != "cuda":
        raise ValueError(f"run_fused takes CPU or CUDA tensors, got {dev}")
    _check_inputs(geom, inj_s, dst_s)
    batch, cycles, p_pes = inj_s.shape
    lp1 = geom.route.shape[0]
    np1, fc = geom.cand.shape
    fi = geom.intab.shape[1]
    depth = geom.depth
    lib = load_library()
    words = lib.noc_step_workspace_words(lp1, np1, depth)
    work = torch.empty((batch, words), dtype=torch.int32, device=dev)
    q_len = torch.empty((batch, lp1), dtype=torch.int32, device=dev)
    m_scal = torch.empty((batch, N_SCALARS), dtype=torch.int32, device=dev)
    m_kind = torch.empty((batch, N_KIND_ROWS, 8), dtype=torch.int32,
                         device=dev)
    passes = torch.empty((batch,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.noc_step_launch(
        inj_s.data_ptr(), dst_s.data_ptr(), geom.route.data_ptr(),
        geom.kind.data_ptr(), geom.prio.data_ptr(), geom.cap.data_ptr(),
        geom.phys.data_ptr(), geom.is_sink.data_ptr(),
        geom.pe_src_link.data_ptr(), geom.inj_pe.data_ptr(),
        geom.cand.data_ptr(), geom.intab.data_ptr(), work.data_ptr(),
        q_len.data_ptr(), m_scal.data_ptr(), m_kind.data_ptr(),
        passes.data_ptr(),
        batch, lp1, p_pes, np1, fc, fi, depth, cycles, warmup,
        starvation_limit, arb_iters, 1 if diagnostics else 0,
        score_pow2(lp1), THREADS, stream)
    if err:
        raise RuntimeError("noc_step kernel launch failed: "
                           + lib.noc_step_error_string(err).decode())
    launches += 1
    return q_len, m_scal, m_kind, passes
