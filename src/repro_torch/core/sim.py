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
the reference's own (``core.prng`` reproduces ``jax.random``).

``backend="cuda"`` runs on a CUDA device or raises; it never falls back to
the CPU or to the twin.  Runtime fault injection (``SimConfig.faults``)
and trace replay are later slices of the port (ROADMAP Queue 1 items 6-7)
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import packet as pk
from repro_torch.core import prng
from repro_torch.core import topology as topo_mod
from repro_torch.core import traffic
from repro_torch.faults.spec import FaultSpec
from repro_torch.kernels import noc_step

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

_UNPORTED_FAULTS = ("runtime fault injection (SimConfig.faults) is not "
                    "ported yet: ROADMAP Queue 1 item 7 (faults slice); "
                    "faults repaired into the fabric "
                    "(TopologySpec(faults=...)) are supported")


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
    faults: Optional[FaultSpec] = None
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
        traffic.resolve(self.pattern)  # raises on unknown patterns
        if self.faults is not None:
            if not isinstance(self.faults, FaultSpec):
                raise TypeError(
                    f"faults must be a FaultSpec, got "
                    f"{type(self.faults).__name__}")
            raise NotImplementedError(_UNPORTED_FAULTS)
        if self.watchdog < 0:
            raise ValueError(
                f"watchdog must be >= 0 cycles, got {self.watchdog}")
        if self.strict_barrier or self.watchdog:
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
    # Trace replay only (a later slice): per-phase completion cycles.
    phase_done: tuple = ()
    # Fraction of (src, dst) pairs with a live route (1.0 healthy; below
    # 1 on a repaired fabric that faults partitioned).
    reachability: float = 1.0
    stall_unretired: int = 0

    @property
    def delivered_fraction(self) -> float:
        """Delivered / offered — the resilience headline (1.0 healthy)."""
        return self.delivered / max(self.offered, 1)

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
        if self.reachability != 1.0:
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


def make_point(cfg: SimConfig, n_pes: int,
               topo: Optional[topo_mod.Topology] = None) -> SweepPoint:
    """Host-side SweepPoint for one SimConfig (pattern strings and
    TrafficSpec instances both resolve through the traffic registry)."""
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
    return SweepPoint(inj_rate=np.float32(cfg.inj_rate),
                      loc_ring=np.float32(loc_ring),
                      loc_block=np.float32(loc_block),
                      seed=int(np.int32(cfg.seed)), use_perm=use_perm,
                      perm_dst=perm)


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
    """Route-independent host arrays, cached on the topology object."""
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
        on_device={},
    )
    topo.__dict__["_torch_geometry_cache"] = cache
    return cache


def build_geometry(topo: topo_mod.Topology, device="cuda") -> Geometry:
    """Device-ready geometry on ``device``.  The structural tables are
    uploaded once per (topology, device); the route table is re-read every
    call so in-place morphs (``core.morph``) take effect immediately."""
    c = _structural_cache(topo)
    dev = torch.device(device)
    static = c["on_device"].get(str(dev))
    if static is None:
        static = c["on_device"][str(dev)] = _upload(
            {k: c[k] for k in GEOMETRY_ARRAYS if k != "route"}, dev)
    route = np.concatenate(
        [topo.route_table.astype(np.int16),
         np.full((1, topo.n_pes), -1, np.int16)], axis=0)
    return Geometry(route=torch.from_numpy(route).to(dev), **static,
                    n_links=topo.n_links, n_phys=topo.n_phys,
                    n_pes=topo.n_pes, depth=c["depth"],
                    cap_total=c["cap_total"])


# ---------------------------------------------------------------------------
# The hot path.
# ---------------------------------------------------------------------------
def draw_streams(points: list[SweepPoint], n_pes: int, cycles: int,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """The traffic streams of ``points`` on ``device``: injections
    [B, cycles, P] bool and destinations [B, cycles, P] int16, drawn
    exactly as the reference's ``_run_core`` draws them."""
    dev = torch.device(device)
    P = n_pes
    shape = (cycles, P)
    pes = torch.arange(P, dtype=torch.int32, device=dev)
    ring_base = pes - pes % pk.PES_PER_RINGLET
    pos_ring = pes % pk.PES_PER_RINGLET
    blk_base = pes - pes % pk.PES_PER_BLOCK
    pos_blk = pes % pk.PES_PER_BLOCK
    inj_all, dst_all = [], []
    for pt in points:
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
    return torch.stack(inj_all), torch.stack(dst_all)


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
    stall_unretired: np.ndarray


def _run_core(geom: Geometry, points: list[SweepPoint], *, cycles: int,
              warmup: int, starvation_limit: int, arb_iters: int = ARB_ITERS,
              diagnostics: bool = False, backend: str = "cuda") -> Metrics:
    """Run a batch of points on one geometry: ``backend="cuda"`` launches
    the kernel once for the whole batch, ``"torch"`` loops the twin."""
    # Queue payload: one packed int32 word per slot, ``born << 11 | dst+1``
    # (n_pes <= 1024 so dst+1 < 2048; empty slot = 0 -> dst -1).
    assert cycles < (1 << 20), "packed born field supports < 2^20 cycles"
    # lat_sum <= cycles * total finite buffer capacity: every in-flight
    # flit accrues one cycle of eventual latency per cycle.
    assert cycles * geom.cap_total < (1 << 31), \
        "int32 lat_sum could overflow for this (cycles, topology) budget"
    inj_s, dst_s = draw_streams(points, geom.n_pes, cycles,
                                geom.route.device)
    kw = dict(warmup=warmup, starvation_limit=starvation_limit,
              arb_iters=arb_iters, diagnostics=diagnostics)
    if backend == "cuda":
        if geom.route.device.type != "cuda":
            raise ValueError("backend='cuda' needs a geometry on a CUDA "
                             "device")
        ql, m_scal, m_kind, _ = noc_step.run_fused(geom, inj_s, dst_s, **kw)
    elif backend == "torch":
        ql, m_scal, m_kind, _ = noc_step.run_plain(geom, inj_s, dst_s, **kw)
    else:  # pragma: no cover - SimConfig validates first
        raise ValueError(f"unknown simulator backend {backend!r}")
    kind_oh = geom.kind[None, :] == torch.arange(
        8, dtype=torch.int32, device=ql.device)[:, None]       # [8, L+1]
    q_len_by_kind = (kind_oh[None] * ql[:, None, :]).sum(dim=2)
    ql, m_scal, m_kind, q_len_by_kind = (
        x.cpu().numpy() for x in (ql, m_scal, m_kind, q_len_by_kind))
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
        stall_unretired=m_scal[:, noc_step.STALL_CREDIT])


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
        reachability=topo.reachable_frac,
        stall_unretired=int(m.stall_unretired[b]),
    )


def run_batch(topo: topo_mod.Topology, cfgs: list[SimConfig], *,
              diagnostics: bool = False) -> tuple[list[SimResult], Metrics]:
    """Run configs that share a static key (cycles, warmup,
    starvation_limit, backend, device) as one batch on ``topo``."""
    c0 = cfgs[0]
    key = _static_key(c0)
    if any(_static_key(c) != key for c in cfgs):
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
                  diagnostics=diagnostics, backend=c0.backend)
    return [_to_result(topo, c, m, b) for b, c in enumerate(cfgs)], m


def _static_key(cfg: SimConfig) -> tuple:
    return (cfg.cycles, cfg.warmup, cfg.starvation_limit, cfg.backend,
            str(cfg.torch_device()))


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
