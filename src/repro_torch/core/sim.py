"""Cycle-level NoC simulator on PyTorch, with a CUDA kernel for the loop.

Model (DESIGN.md §4), as in the reference ``repro.core.sim``: every
buffered channel is a directed link with a small FIFO queue (depth 2 = the
paper's two VCs per input port; the PE inject buffer is deeper).  Each
cycle:

1. every queue head looks up its next link in the static route table;
2. contenders for the same output link arbitrate: static priority (in-ring
   > router > PE-inject, §4.2) with a rotating round-robin tiebreak and
   anti-starvation aging (the paper's weighted round-robin);
3. winners move one hop if the target queue has space; moves into EJECT
   sinks are deliveries;
4. traffic generators inject single-flit packets Bernoulli(Ir) per PE
   (§7.2), with optional ringlet/block locality (§3's operating regime).

The step math lives in ``kernels.noc_step`` and runs behind
``SimConfig(backend=...)``: ``"cuda"`` (the default) runs the whole cycle
loop as one launch of the hand-written CUDA kernel, ``"torch"`` loops the
plain twin ``cycle_step`` on ``SimConfig.device``.  Both keep every
accumulator in int32, so they agree bit for bit with each other and with
the reference for the same configuration and seed: the random streams are
the reference's own (``core.prng`` reproduces ``jax.random``; on a CUDA
device ``kernels.streams`` draws a whole batch's in one launch).

``backend="cuda"`` runs on a CUDA device or raises; it never falls back to
the CPU or to the twin.  Both backends run the reference's three modes:
statistical traffic, trace replay (a ``repro_torch.trace.Trace`` pattern:
phase-gated injection, ``strict_barrier`` and the stall ``watchdog``) and
runtime fault injection (``SimConfig.faults``: per-link drop masks on the
healthy geometry, with a sixth random stream for the drop draws).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import packet as pk
from repro_torch.core import prng
from repro_torch.core import topology as topo_mod
from repro_torch.core import traffic
from repro_torch.faults.spec import FaultSpec
from repro_torch.kernels import noc_step, streams

BACKENDS = ("torch", "cuda")

# Legacy string patterns (resolve through the ``core.traffic`` registry).
UNIFORM = "uniform"
BIT_REVERSAL = "bit_reversal"
TRANSPOSE = "transpose"
SHUFFLE = "shuffle"
TORNADO = "tornado"
HOTSPOT = "hotspot"
PATTERNS = (UNIFORM, BIT_REVERSAL, TRANSPOSE, SHUFFLE, TORNADO, HOTSPOT)

# Arbitration fixpoint iteration cap (the reference's): the counter starts
# at 1, so at most ARB_ITERS - 1 re-arbitrations run; any residue beyond
# them is counted in `lost`.
ARB_ITERS = 24

@dataclasses.dataclass(frozen=True)
class SimConfig:
    cycles: int = 2000
    warmup: int = 500
    inj_rate: float = 0.25
    pattern: Union[str, traffic.TrafficSpec] = UNIFORM
    locality_ringlet: float = 0.0
    locality_block: float = 0.0
    seed: int = 0
    starvation_limit: int = 8
    backend: str = "cuda"  # "cuda" (the kernel) | "torch" (the plain twin)
    # Fault injection (repro_torch.faults): faults are lowered to a per-link
    # drop mask inside the cycle step — routing is untouched, so whole
    # resilience grids batch on the healthy geometry.
    faults: Optional[FaultSpec] = None
    # Trace replay semantics under faults: with strict_barrier a phase
    # barrier retires *delivered* flits only (dropped flits leave the
    # barrier waiting forever on a dead link); the watchdog then detects
    # a phase making no progress for `watchdog` consecutive cycles and
    # terminates with a per-phase diagnostic instead of spinning to
    # budget exhaustion.  0 disables the watchdog.
    strict_barrier: bool = False
    watchdog: int = 0
    # Where the run is placed (None = "cuda").  Not part of the result's
    # identity: both backends give the same bits on any device, so it is
    # left out of equality, hashing and the JSON form.
    device: Optional[str] = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.backend == "cuda" and self.torch_device().type != "cuda":
            raise ValueError(
                f"backend='cuda' runs on a CUDA device, got device="
                f"{self.device!r}; use backend='torch' for the plain twin")
        if not 0.0 <= self.inj_rate <= 1.0:
            raise ValueError(
                f"inj_rate must be in [0, 1], got {self.inj_rate}")
        if self.cycles <= 0:
            raise ValueError(f"cycles must be > 0, got {self.cycles}")
        if not 0 <= self.warmup < self.cycles:
            raise ValueError(
                f"warmup must satisfy 0 <= warmup < cycles, got "
                f"warmup={self.warmup} cycles={self.cycles}")
        spec = traffic.resolve(self.pattern)  # raises on unknown patterns
        if spec.is_trace and self.warmup != 0:
            raise ValueError(
                "trace replay needs warmup=0: per-phase completion cycles "
                "count from cycle 0 and every injected flit is workload")
        if self.faults is not None and not isinstance(self.faults,
                                                      FaultSpec):
            raise TypeError(
                f"faults must be a FaultSpec, got "
                f"{type(self.faults).__name__}")
        if self.watchdog < 0:
            raise ValueError(
                f"watchdog must be >= 0 cycles, got {self.watchdog}")
        if (self.strict_barrier or self.watchdog) and not spec.is_trace:
            raise ValueError(
                "strict_barrier/watchdog are trace-replay semantics "
                "(phase barriers); statistical traffic has no barrier "
                "to watch")
        if not 0 <= self.locality_ringlet + self.locality_block <= 1:
            raise ValueError("locality fractions must sum to <= 1")
        if isinstance(self.pattern, traffic.TrafficSpec) and (
                self.locality_ringlet or self.locality_block):
            raise ValueError(
                "locality is declared on the TrafficSpec when one is "
                "passed as `pattern`; leave SimConfig's locality at 0")

    def torch_device(self) -> torch.device:
        return torch.device(self.device if self.device is not None
                            else "cuda")

    def effective_locality(self) -> tuple[float, float]:
        """(ringlet, block) fractions that drive traffic generation: the
        spec's when ``pattern`` is a TrafficSpec, else this config's."""
        if isinstance(self.pattern, traffic.TrafficSpec):
            return (self.pattern.locality_ringlet,
                    self.pattern.locality_block)
        return self.locality_ringlet, self.locality_block


@dataclasses.dataclass(frozen=True)
class SimResult:
    topology: str
    n_pes: int
    cfg: SimConfig
    delivered: int
    offered: int
    accepted: int
    dropped: int
    lost: int        # exactness-guard counter; 0 in all validated runs
    in_flight: int   # flits still queued at the end (conservation checks)
    measured_cycles: int
    avg_latency: float          # generation -> ejection, cycles
    throughput: float           # delivered packets / cycle
    flit_hops_per_cycle: float  # link traversals / cycle (activity factor)
    per_pe_throughput: float
    # Trace replay only (DESIGN.md §12): the cycle each phase's last flit
    # retired, -1 for phases the cycle budget did not complete, and
    # ``-2 - cycle`` for a phase the stall watchdog terminated at
    # ``cycle`` (DESIGN.md §13).  Empty for statistical traffic.
    phase_done: tuple = ()
    # Graceful degradation: fraction of (src, dst) pairs with a live route
    # (1.0 for healthy fabrics), and — when the stall watchdog fired — the
    # credits the stalled phase never retired.
    reachability: float = 1.0
    stall_unretired: int = 0

    @property
    def n_phases(self) -> int:
        return len(self.phase_done)

    @property
    def trace_completed(self) -> bool:
        """True when every phase of a trace replay finished in budget."""
        return bool(self.phase_done) and self.phase_done[-1] >= 0

    @property
    def delivered_fraction(self) -> float:
        """Delivered / offered — the resilience headline (1.0 healthy)."""
        return self.delivered / max(self.offered, 1)

    @property
    def stalled_phase(self) -> int:
        """Index of the trace phase the stall watchdog terminated, or -1
        (phases encode the stall as ``phase_done = -2 - cycle``)."""
        for i, d in enumerate(self.phase_done):
            if d <= -2:
                return i
        return -1

    @property
    def stall_cycle(self) -> int:
        """Cycle at which the watchdog fired, or -1 if it never did."""
        i = self.stalled_phase
        return -2 - self.phase_done[i] if i >= 0 else -1

    @property
    def completion_cycles(self) -> int:
        """Cycles to drain the whole trace (last phase's completion cycle
        + 1, since cycles are 0-based); -1 if the budget ran out."""
        if not self.trace_completed:
            return -1
        return self.phase_done[-1] + 1

    def phase_latencies(self) -> tuple[int, ...]:
        """Per-phase cycle cost: completion-cycle deltas between
        consecutive phase barriers (phase 0 counts from cycle 0).
        Incomplete phases report -1."""
        out, prev = [], -1
        for d in self.phase_done:
            out.append(d - prev if d >= 0 else -1)
            prev = d
        return tuple(out)

    def row(self) -> dict:
        r = {
            "topology": self.topology, "n_pes": self.n_pes,
            "pattern": traffic.name_of(self.cfg.pattern),
            "inj_rate": self.cfg.inj_rate,
            "avg_latency": round(self.avg_latency, 2),
            "throughput": round(self.throughput, 3),
            "per_pe_throughput": round(self.per_pe_throughput, 4),
            "flit_hops_per_cycle": round(self.flit_hops_per_cycle, 3),
            "delivered": self.delivered, "offered": self.offered,
            "dropped": self.dropped, "lost": self.lost,
            "in_flight": self.in_flight,
        }
        if self.phase_done:
            r["n_phases"] = self.n_phases
            r["completion_cycles"] = self.completion_cycles
            r["phase_latencies"] = list(self.phase_latencies())
            if self.stalled_phase >= 0:
                r["stalled_phase"] = self.stalled_phase
                r["stall_cycle"] = self.stall_cycle
                r["stall_unretired"] = self.stall_unretired
        if self.reachability != 1.0 or (self.cfg is not None
                                        and self.cfg.faults):
            r["reachability"] = round(self.reachability, 4)
            r["delivered_fraction"] = round(self.delivered_fraction, 4)
        return r


def pattern_destinations(pattern: Union[str, traffic.TrafficSpec],
                         n_pes: int) -> Optional[np.ndarray]:
    """Fixed destination map (None = uniform-random)."""
    return traffic.resolve(pattern).destinations(n_pes)


# ---------------------------------------------------------------------------
# Per-point parameters.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One sweep-grid coordinate (host values; the streams are drawn on the
    run's device).  ``inj_rate`` and the localities are float32, as the
    reference traces them."""
    inj_rate: np.float32
    loc_ring: np.float32
    loc_block: np.float32
    seed: int
    use_perm: bool
    perm_dst: np.ndarray  # [n_pes] int32
    # Trace replay tables: [n_phases, n_pes] int32 per-phase destination
    # map and flit counts.  Statistical points carry the empty [0, n_pes]
    # shape; points batch together only with equal phase counts.
    ph_dst: np.ndarray
    ph_flits: np.ndarray
    # Trace replay in records form (``trace.TraceRecords`` with a source
    # that sends several records in a phase): each source's first record
    # of each phase [n_phases, n_pes], and every record's destination and
    # running end [R] int32.  ph_dst then holds each source's first
    # record's destination and ph_flits its phase total.  Empty ([0, n_pes]
    # and [0]) otherwise.
    rec_start: np.ndarray
    rec_dst: np.ndarray
    rec_end: np.ndarray
    # Fault injection: lowered per-queue drop entries (queue id, drop
    # probability, onset cycle).  Healthy points carry the empty [0]
    # shape; faulted points are padded to a small bucket, so nearby fault
    # counts share one batch.
    fault_links: np.ndarray   # [F] int32 queue ids (pad -> n_links)
    fault_drop_p: np.ndarray  # [F] float32 (pad -> 0.0)
    fault_onset: np.ndarray   # [F] int32


def make_point(cfg: SimConfig, n_pes: int,
               topo: Optional[topo_mod.Topology] = None) -> SweepPoint:
    """Host-side SweepPoint for one SimConfig (pattern strings and
    TrafficSpec instances both resolve through the traffic registry).
    ``topo`` is required only when ``cfg.faults`` is set — fault ids
    lower to queue-level drop entries against the concrete topology."""
    spec = traffic.resolve(cfg.pattern)
    perm = spec.destinations(n_pes)
    use_perm = perm is not None
    if perm is None:
        perm = np.zeros((n_pes,), np.int32)
    else:
        perm = np.asarray(perm)
        if (perm.shape != (n_pes,)
                or not np.issubdtype(perm.dtype, np.integer)
                or perm.min() < 0 or perm.max() >= n_pes):
            raise ValueError(
                f"traffic spec {traffic.name_of(spec)!r} produced an invalid "
                f"destination map for {n_pes} PEs "
                f"(shape {perm.shape}, dtype {perm.dtype}); expected int "
                f"[{n_pes}] with entries in [0, {n_pes})")
        perm = perm.astype(np.int32)
    loc_ring, loc_block = cfg.effective_locality()
    recs = None
    if spec.is_trace:
        ph_dst, ph_flits = spec.trace_arrays(n_pes)
        ph_dst = np.asarray(ph_dst, np.int32)
        ph_flits = np.asarray(ph_flits, np.int32)
        recs = spec.trace_records(n_pes)
        if recs is not None:
            telemetry.count("trace.records", recs[1].shape[0])
    else:
        ph_dst = np.zeros((0, n_pes), np.int32)
        ph_flits = np.zeros((0, n_pes), np.int32)
    if recs is None:
        recs = (np.zeros((0, n_pes), np.int32), np.zeros((0,), np.int32),
                np.zeros((0,), np.int32))
    if cfg.faults:
        if topo is None:
            raise ValueError(
                "SimConfig.faults lowers against the concrete topology; "
                "call make_point(cfg, n_pes, topo)")
        cfg.faults.validate_against(topo)
        f_links, f_drop_p, f_onset = cfg.faults.lower(topo)
    else:
        f_links = np.zeros((0,), np.int32)
        f_drop_p = np.zeros((0,), np.float32)
        f_onset = np.zeros((0,), np.int32)
    return SweepPoint(inj_rate=np.float32(cfg.inj_rate),
                      loc_ring=np.float32(loc_ring),
                      loc_block=np.float32(loc_block),
                      seed=int(np.int32(cfg.seed)), use_perm=use_perm,
                      perm_dst=perm, ph_dst=ph_dst, ph_flits=ph_flits,
                      rec_start=recs[0], rec_dst=recs[1], rec_end=recs[2],
                      fault_links=f_links, fault_drop_p=f_drop_p,
                      fault_onset=f_onset)


# ---------------------------------------------------------------------------
# Geometry: topology arrays preprocessed for the scatter-free step.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Geometry:
    """Device-ready topology view, on one device.

    ``cand``/``intab`` are *structural* fan-in tables: queue q can only
    ever receive a flit from a queue whose destination node is q's source
    node, so they are supersets of any route table's live edges and stay
    valid across morphs.  Runtime masks select the live subset.
    """
    route: torch.Tensor      # [L+1, P] int16 (one upload per route array)
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
    # The kernel's views (``kernels.noc_step.layout``): one dict for every
    # geometry that ``build_geometry`` makes of a topology on a device.
    kernel: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)


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


def geometry_from_arrays(arrays: dict, *, depth: int, cap_total: int,
                         device) -> Geometry:
    """A ``Geometry`` from host arrays: ``np.asarray`` of the reference
    ``Geometry``'s ten device arrays (``GEOMETRY_ARRAYS``), or the port's
    own.  This is how state is carried across from the reference."""
    host = {k: np.asarray(arrays[k]) for k in GEOMETRY_ARRAYS}
    _check_inject_rows(host["inj_pe"], host["pe_src_link"])
    lp1, p = host["route"].shape
    return Geometry(**_upload(host, torch.device(device)), n_links=lp1 - 1,
                    n_phys=host["cand"].shape[0] - 1, n_pes=p,
                    depth=int(depth), cap_total=int(cap_total))


def _structural_cache(topo: topo_mod.Topology) -> dict:
    """Route-independent host arrays, cached on the topology object, with
    ``build_geometry``'s device state: one entry a device (``devices``)."""
    cache = topo.__dict__.get("_torch_geometry_cache")
    if cache is not None:
        return cache
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
    cand = np.full((topo.n_phys + 1, fi), L, np.int32)
    phys = topo.link_phys
    for q in range(L):
        if src[q] >= 0:
            b = buckets[src[q]]
            intab[q, :len(b)] = b
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
        devices={},
    )
    topo.__dict__["_torch_geometry_cache"] = cache
    return cache


# The telemetry counters of ``build_geometry``'s device route: one a call.
ROUTE_UPLOADED, ROUTE_REUSED = ("geometry.route[uploaded]",
                                "geometry.route[reused]")


@telemetry.spanned("sim.build_geometry")
def build_geometry(topo: topo_mod.Topology, device="cuda") -> Geometry:
    """Device-ready geometry on ``device``.  A topology holds one entry a
    device: the structural tables, uploaded once; the route table, uploaded
    once per array (while ``topo.route_table`` is the array last uploaded,
    the call reuses its device copy); and the ``kernel`` dict that every
    geometry built from the entry shares.  Reassigning the attribute (a
    morph, a reset, a repair) takes effect at the next call; an uploaded
    array is made read-only, so an in-place write after a run raises
    instead of leaving the device copy stale."""
    c = _structural_cache(topo)
    dev = torch.device(device)
    entry = c["devices"].get(str(dev))
    if entry is None:
        entry = c["devices"][str(dev)] = dict(
            static=_upload({k: c[k] for k in GEOMETRY_ARRAYS if k != "route"},
                           dev), route=(None, None), kernel={})
    host = topo.route_table
    # The entry holds the host array it came from, so its id is not reused.
    held, route = entry["route"]
    if held is host:
        telemetry.count(ROUTE_REUSED)
    else:
        host.flags.writeable = False
        padded = np.concatenate(
            [host.astype(np.int16), np.full((1, topo.n_pes), -1, np.int16)],
            axis=0)
        route = torch.from_numpy(padded).to(dev)
        entry["route"] = (host, route)
        telemetry.count(ROUTE_UPLOADED)
    return Geometry(route=route, **entry["static"],
                    n_links=topo.n_links, n_phys=topo.n_phys,
                    n_pes=topo.n_pes, depth=c["depth"],
                    cap_total=c["cap_total"], kernel=entry["kernel"])


# ---------------------------------------------------------------------------
# The hot path.
# ---------------------------------------------------------------------------
@telemetry.spanned("sim.draw_streams")
def draw_streams(points: list[SweepPoint], n_pes: int, cycles: int,
                 device) -> tuple[torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """The random streams of ``points`` on ``device``, drawn exactly as
    the reference's ``_run_core`` draws them: injections [B, cycles, P]
    bool, destinations [B, cycles, P] int16, and — when the points carry
    fault entries (all of a batch carry the same count F) — the fault
    draws [B, cycles, F] float32, else None.  Faulted points split their
    key six ways, healthy points five, as the reference does, so healthy
    streams are the same with or without faults in the grid.

    On a CUDA device one launch of the streams kernel
    (``kernels.streams.draw``) draws the whole batch; on any other device
    the plain version, ``_draw_streams_plain``, loops over the points.
    Both give the same bits; ``kernels.streams.launches()`` counts the
    batches each path drew."""
    dev = torch.device(device)
    n_faults = points[0].fault_links.shape[0]
    if any(pt.fault_links.shape[0] != n_faults for pt in points):
        raise ValueError("points of one batch must share a fault count")
    telemetry.count("streams.points", len(points))
    if dev.type == "cuda":
        return streams.draw(points, n_pes, cycles, dev)
    return _draw_streams_plain(points, n_pes, cycles, dev)


def _draw_streams_plain(points: list[SweepPoint], n_pes: int, cycles: int,
                        dev: torch.device):
    """``draw_streams`` in plain tensor code over ``core.prng``, one point
    at a time: the CPU's path and the streams kernel's oracle."""
    P = n_pes
    shape = (cycles, P)
    pes = torch.arange(P, dtype=torch.int32, device=dev)
    ring_base = pes - pes % pk.PES_PER_RINGLET
    pos_ring = pes % pk.PES_PER_RINGLET
    blk_base = pes - pes % pk.PES_PER_BLOCK
    pos_blk = pes % pk.PES_PER_BLOCK
    n_faults = points[0].fault_links.shape[0]
    telemetry.count(streams.LAUNCH_COUNTERS[streams.PLAIN])
    inj_all, dst_all, fu_all = [], [], []
    for pt in points:
        if n_faults:
            k_inj, k_dst, k_loc, k_ring, k_blk, k_flt = prng.split(
                prng.key(pt.seed, dev), 6)
            fu_all.append(prng.uniform(k_flt, (cycles, n_faults)))
        else:
            k_inj, k_dst, k_loc, k_ring, k_blk = prng.split(
                prng.key(pt.seed, dev), 5)
        f32 = dict(dtype=torch.float32, device=dev)
        inj_s = prng.bernoulli(k_inj, torch.tensor(pt.inj_rate, **f32),
                               shape)
        off_s = prng.randint(k_dst, shape, 1, P)
        u_s = prng.uniform(k_loc, shape)
        ring_s = prng.randint(k_ring, shape, 1, pk.PES_PER_RINGLET)
        blk_s = prng.randint(k_blk, shape, 1, pk.PES_PER_BLOCK)
        if pt.use_perm:
            base_s = torch.as_tensor(pt.perm_dst, dtype=torch.int32,
                                     device=dev).expand(shape)
        else:
            base_s = (pes[None, :] + off_s) % P  # uniform over everyone else
        ring_peer = ring_base + (pos_ring[None, :] + ring_s) % \
            pk.PES_PER_RINGLET
        blk_peer = blk_base + (pos_blk[None, :] + blk_s) % pk.PES_PER_BLOCK
        # Both thresholds are float32, and so is their sum: a Python-float
        # sum can differ from the reference by one ulp.
        loc_ring = torch.tensor(pt.loc_ring, **f32)
        loc_both = loc_ring + torch.tensor(pt.loc_block, **f32)
        dst_s = torch.where(u_s < loc_ring, ring_peer,
                            torch.where(u_s < loc_both, blk_peer, base_s))
        inj_all.append(inj_s)
        dst_all.append(dst_s.to(torch.int16))
    fault_u = torch.stack(fu_all) if n_faults else None
    return torch.stack(inj_all), torch.stack(dst_all), fault_u


@telemetry.spanned("sim.batch_operands")
def batch_operands(points: list[SweepPoint], n_pes: int, cycles: int,
                   device):
    """Everything the cycle loop reads for a batch of points, on
    ``device``: ``(inj_s, dst_s, trace, faults, fault_u)`` — the streams
    of ``draw_streams``, the trace triple ``(ph_dst, ph_flits, ph_total)``
    (None for statistical traffic) and the fault triple ``(links, drop_p,
    onset)`` (None for healthy points), stacked over the batch."""
    dev = torch.device(device)
    inj_s, dst_s, fault_u = draw_streams(points, n_pes, cycles, dev)

    def stacked(field, dtype):
        return torch.from_numpy(np.stack(
            [getattr(pt, field) for pt in points])).to(dtype).to(dev)

    # Trace replay: the phase tables ride the points as data; their
    # [n_phases, P] shape is the batch's.  Where a point sends several
    # records a phase from one source, the batch carries the record tables
    # too (every point's, padded to the longest).
    trace = None
    if points[0].ph_dst.shape[0]:
        ph_flits = stacked("ph_flits", torch.int32)
        trace = (stacked("ph_dst", torch.int32), ph_flits,
                 ph_flits.sum(dim=2, dtype=torch.int32))
        if any(pt.rec_dst.shape[0] for pt in points):
            trace += record_tables(points, dev)
    faults = None
    if fault_u is not None:
        faults = (stacked("fault_links", torch.int32),
                  stacked("fault_drop_p", torch.float32),
                  stacked("fault_onset", torch.int32))
    return inj_s, dst_s, trace, faults, fault_u


def record_tables(points: list[SweepPoint], device):
    """The batch's record tables on ``device``: ``(start [B, n_phases, P],
    dst [B, R], end [B, R])`` int32, R the most records of any point.  A
    point in one-record form sends its phase tables' one record a source
    (start = the source's id in each phase's row)."""
    tabs = []
    for pt in points:
        if pt.rec_dst.shape[0]:
            tabs.append((pt.rec_start, pt.rec_dst, pt.rec_end))
        else:
            n_ph, p = pt.ph_dst.shape
            tabs.append((np.arange(n_ph * p, dtype=np.int32).reshape(n_ph, p),
                         pt.ph_dst.reshape(-1), pt.ph_flits.reshape(-1)))
    n_rec = max(t[1].shape[0] for t in tabs)

    def padded(a):
        return np.pad(a, (0, n_rec - a.shape[0]))
    host = (np.stack([t[0] for t in tabs]),
            np.stack([padded(t[1]) for t in tabs]),
            np.stack([padded(t[2]) for t in tabs]))
    return tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                 for a in host)


@dataclasses.dataclass(frozen=True)
class Metrics:
    """Integer metrics of a batch of points, as host arrays ([B] each,
    [B, 8] for the per-kind rows)."""
    delivered: np.ndarray
    offered: np.ndarray
    accepted: np.ndarray
    dropped: np.ndarray
    lost: np.ndarray
    lat_sum: np.ndarray
    moved: np.ndarray
    in_flight: np.ndarray
    wins_by_kind: np.ndarray
    stall_next_kind: np.ndarray
    q_len_by_kind: np.ndarray
    phase_done: np.ndarray       # [B, n_phases] ([B, 0] when statistical)
    stall_unretired: np.ndarray


@telemetry.spanned("sim._run_core")
def _run_core(geom: Geometry, points: list[SweepPoint], *, cycles: int,
              warmup: int, starvation_limit: int, arb_iters: int = ARB_ITERS,
              diagnostics: bool = False, backend: str = "cuda",
              strict_barrier: bool = False, watchdog: int = 0) -> Metrics:
    """Run a batch of points on one geometry: ``backend="cuda"`` launches
    the kernel once for the whole batch, ``"torch"`` loops the twin.  The
    points share their trace phase count and their fault count.  While
    telemetry is on, the launch's arbitration passes of each point are
    kept (``noc_step.passes``)."""
    # Queue payload: one packed int32 word per slot, ``born << 11 | dst+1``
    # (n_pes <= 1024 so dst+1 < 2048; empty slot = 0 -> dst -1).
    assert cycles < (1 << 20), "packed born field supports < 2^20 cycles"
    # lat_sum <= cycles * total finite buffer capacity: every in-flight
    # flit accrues one cycle of eventual latency per cycle.
    assert cycles * geom.cap_total < (1 << 31), \
        "int32 lat_sum could overflow for this (cycles, topology) budget"
    dev = geom.route.device
    inj_s, dst_s, trace, faults, fault_u = batch_operands(points,
                                                          geom.n_pes,
                                                          cycles, dev)
    kw = dict(warmup=warmup, starvation_limit=starvation_limit,
              arb_iters=arb_iters, trace=trace, faults=faults,
              fault_u=fault_u, strict_barrier=strict_barrier,
              watchdog=watchdog, diagnostics=diagnostics)
    # SimConfig validates the backend; run_fused refuses a CPU geometry.
    run = noc_step.run_fused if backend == "cuda" else noc_step.run_plain
    ql, m_scal, m_kind, passes, ph_done = run(geom, inj_s, dst_s, **kw)
    telemetry.kernel("noc_step.passes", backend=backend, cycles=cycles,
                     passes=passes)
    kind_oh = geom.kind[None, :] == torch.arange(
        8, dtype=torch.int32, device=ql.device)[:, None]       # [8, L+1]
    q_len_by_kind = (kind_oh[None] * ql[:, None, :]).sum(dim=2)
    ql, m_scal, m_kind, q_len_by_kind, ph_done = (
        x.cpu().numpy() for x in (ql, m_scal, m_kind, q_len_by_kind,
                                  ph_done))
    return Metrics(
        delivered=m_scal[:, noc_step.DELIVERED],
        offered=m_scal[:, noc_step.OFFERED],
        accepted=m_scal[:, noc_step.ACCEPTED],
        dropped=m_scal[:, noc_step.DROPPED],
        lost=m_scal[:, noc_step.LOST],
        lat_sum=m_scal[:, noc_step.LAT_SUM],
        moved=m_scal[:, noc_step.MOVED],
        in_flight=ql.sum(axis=1, dtype=np.int64).astype(np.int32),
        wins_by_kind=m_kind[:, noc_step.KIND_WINS],
        stall_next_kind=m_kind[:, noc_step.KIND_STALLS],
        q_len_by_kind=q_len_by_kind.astype(np.int32),
        phase_done=ph_done,
        stall_unretired=m_scal[:, noc_step.STALL_CREDIT])


# Host-side reachability cache: FaultSpec is frozen/hashable and the
# route walk is pure, so one walk serves every point sharing (topology,
# fault set) in a sweep grid.  An entry holds a weak reference to its
# topology: a later one at the same address is not served it.
_REACH_CACHE: dict = {}


@telemetry.spanned("sim._fault_reachability")
def _fault_reachability(topo: topo_mod.Topology,
                        faults: Optional[FaultSpec]) -> float:
    if not faults:
        return topo.reachable_frac  # 1.0 healthy; baked value if repaired
    key = (id(topo), faults)
    hit = _REACH_CACHE.get(key)
    if hit is None or hit[0]() is not topo:
        dead = faults.dead_queue_mask(topo)
        hit = (weakref.ref(topo), topo.reachable_frac if not dead.any()
               else topo_mod.reachable_fraction(topo, dead))
        if len(_REACH_CACHE) > 512:
            _REACH_CACHE.clear()
        _REACH_CACHE[key] = hit
    return hit[1]


def _to_result(topo: topo_mod.Topology, cfg: SimConfig, m: Metrics,
               b: int) -> SimResult:
    """Host-side conversion of batch entry ``b`` (identical for single and
    batched runs, which keeps the sweep/simulate equivalence exact)."""
    mc = cfg.cycles - cfg.warmup
    delivered = int(m.delivered[b])
    return SimResult(
        topology=topo.name, n_pes=topo.n_pes, cfg=cfg,
        delivered=delivered,
        offered=int(m.offered[b]),
        accepted=int(m.accepted[b]),
        dropped=int(m.dropped[b]),
        lost=int(m.lost[b]),
        in_flight=int(m.in_flight[b]),
        measured_cycles=mc,
        avg_latency=int(m.lat_sum[b]) / max(delivered, 1),
        throughput=delivered / mc,
        flit_hops_per_cycle=int(m.moved[b]) / mc,
        per_pe_throughput=delivered / mc / topo.n_pes,
        phase_done=tuple(int(d) for d in m.phase_done[b]),
        reachability=_fault_reachability(topo, cfg.faults),
        stall_unretired=int(m.stall_unretired[b]),
    )


@telemetry.spanned("sim.run_batch")
def run_batch(topo: topo_mod.Topology, cfgs: list[SimConfig], *,
              diagnostics: bool = False) -> tuple[list[SimResult], Metrics]:
    """Run configs that share a static key (cycles, warmup,
    starvation_limit, backend, device, barrier semantics, trace phase
    count, lowered fault count) as one batch on ``topo``."""
    c0 = cfgs[0]
    key = _static_key(c0, topo)
    if any(_static_key(c, topo) != key for c in cfgs):
        raise ValueError("run_batch needs configs with one static key; "
                         "core.sweep groups them")
    dev = c0.torch_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"backend={c0.backend!r} runs on a CUDA device and none is "
            "available; backend='torch' with device='cpu' runs the plain "
            "twin on the CPU")
    geom = build_geometry(topo, dev)
    points = [make_point(c, topo.n_pes, topo) for c in cfgs]
    m = _run_core(geom, points, cycles=c0.cycles, warmup=c0.warmup,
                  starvation_limit=c0.starvation_limit,
                  diagnostics=diagnostics, backend=c0.backend,
                  strict_barrier=c0.strict_barrier, watchdog=c0.watchdog)
    return [_to_result(topo, c, m, b) for b, c in enumerate(cfgs)], m


def _static_key(cfg: SimConfig, topo: topo_mod.Topology) -> tuple:
    """What configs must share to run as one batch: the run's statics and
    two array shapes — the trace phase count (0 for statistical traffic)
    and the padded fault-entry count (0 for healthy points)."""
    n_faults = cfg.faults.n_lowered(topo) if cfg.faults else 0
    return (cfg.cycles, cfg.warmup, cfg.starvation_limit, cfg.backend,
            str(cfg.torch_device()), cfg.strict_barrier, cfg.watchdog,
            traffic.resolve(cfg.pattern).n_trace_phases, n_faults)


def simulate(topo: topo_mod.Topology, cfg: SimConfig) -> SimResult:
    """Run one simulation; returns steady-state metrics."""
    return run_batch(topo, [cfg])[0][0]


def kind_diagnostics(topo: topo_mod.Topology, cfg: SimConfig) -> dict:
    """Per-queue-kind instrumentation: arbitration wins, stalls-by-blocking
    -kind, and final occupancy (the benchmark/sweep hot path skips these
    counters)."""
    _, m = run_batch(topo, [cfg], diagnostics=True)
    names = topo_mod.KIND_NAMES
    return {
        field: {names[k]: int(getattr(m, field)[0][k]) for k in names}
        for field in ("wins_by_kind", "stall_next_kind", "q_len_by_kind")
    }


# Paper operating regime (§1/§3): "the majority of the traffic remains
# restricted to the rings". Used by the figure-reproduction benchmarks.
PAPER_LOCALITY = dict(locality_ringlet=0.75, locality_block=0.20)
