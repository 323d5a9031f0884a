"""The plain reference of a benchmark request.

From a request as the generator writes it (plain dicts: the fabric, the
points' patterns, rates and seeds, the dead links), it works out again
everything the program derives: the topology and its route tables, the
fault lowering and the repair re-routing, the random streams, the cycle
loop, the reachability, the report's models and the repaired fabric's
certificate.  Outputs are plain dicts in the shape ``check`` compares.

``precision="bfloat16"`` is the control: the float32 draws and thresholds
of the streams and of the fault drops rounded to bfloat16 before they are
compared, the step below what the configuration states.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import cycle, fabric, models, prng
from . import topology as topo_mod

# Arbitration fixpoint cap: at most ARB_ITERS - 1 re-arbitrations a cycle.
ARB_ITERS = 24
_PAD_FLOOR = 16
PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# -- the fabric -------------------------------------------------------------
def build(fabric_cfg: dict, dead_links=()) -> topo_mod.Topology:
    """The topology of ``fabric_cfg`` (family, n_pes, queue_depth,
    src_queue_depth), with ``dead_links`` repaired into its route tables."""
    t = topo_mod.build(fabric_cfg["family"], fabric_cfg["n_pes"],
                       fabric_cfg["queue_depth"],
                       fabric_cfg["src_queue_depth"])
    dead = dead_queue_mask(t, dead_links)
    if dead.any():
        t.route_table, t.reachable = topo_mod.reroute_avoiding(t, dead)
        t.dead_queues = dead
    return t


def fabric_channels(topo: topo_mod.Topology) -> np.ndarray:
    """Sorted physical channel ids of the fabric's queues (not the PE
    inject and eject buffers)."""
    return np.unique(topo.link_phys[np.isin(topo.link_kind,
                                            topo_mod._FABRIC_KINDS)])


def dead_queue_mask(topo: topo_mod.Topology, dead_links) -> np.ndarray:
    dead = np.zeros(topo.n_links, bool)
    if len(dead_links):
        dead |= np.isin(topo.link_phys, np.asarray(dead_links))
    return dead & np.isin(topo.link_kind, topo_mod._FABRIC_KINDS)


def lower(topo: topo_mod.Topology, dead_links):
    """Drop entries ``(links, drop_p, onset)`` of the dead links' queues,
    padded to 16, then to powers of two, with never-firing entries."""
    qs = np.nonzero(dead_queue_mask(topo, dead_links))[0]
    pad = _PAD_FLOOR
    while pad < len(qs):
        pad *= 2
    links = np.full(pad, topo.n_links, np.int32)
    links[:len(qs)] = qs
    drop_p = np.zeros(pad, np.float32)
    drop_p[:len(qs)] = 1.0
    return links, drop_p, np.zeros(pad, np.int32)


# -- traffic ----------------------------------------------------------------
def destinations(pattern: str, n_pes: int):
    """The fixed destination map of a permutation pattern, None for
    uniform-random traffic."""
    if pattern == "uniform":
        return None
    bits = int(np.log2(n_pes))
    assert (1 << bits) == n_pes, n_pes
    x = np.arange(n_pes)
    if pattern == "bit_reversal":
        out = np.zeros_like(x)
        for i in range(bits):
            out = out | (((x >> i) & 1) << (bits - 1 - i))
        return out.astype(np.int32)
    if pattern == "transpose":
        half = bits // 2
        return (((x << half) | (x >> (bits - half)))
                & ((1 << bits) - 1)).astype(np.int32)
    raise ValueError(f"unknown pattern {pattern!r}")


def draw_streams(points: list[dict], n_pes: int, cycles: int, n_faults: int,
                 device, precision: str = "float32"):
    """Injections [B, cycles, P] bool, destinations [B, cycles, P] int16
    and, with fault entries, the drop draws [B, cycles, F]: the key of a
    point's seed split five ways (six with faults), a Bernoulli stream,
    three randint streams and a uniform one, as the program draws them."""
    dev = torch.device(device)
    low = PRECISIONS[precision]
    P, RP, PB = n_pes, topo_mod.PES_PER_RINGLET, topo_mod.PES_PER_BLOCK
    shape = (cycles, P)
    pes = torch.arange(P, dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    inj_all, dst_all, fu_all = [], [], []
    for pt in points:
        keys = prng.split(prng.key(int(np.int32(pt["seed"])), dev),
                          6 if n_faults else 5)
        if n_faults:
            fu_all.append(prng.uniform(keys[5], (cycles, n_faults))
                          .to(low).float())
        p = torch.tensor(np.float32(pt["inj_rate"]), **f32).to(low)
        inj_s = prng.uniform(keys[0], shape).to(low) < p
        off_s = prng.randint(keys[1], shape, 1, P)
        u_s = prng.uniform(keys[2], shape).to(low)
        ring_s = prng.randint(keys[3], shape, 1, RP)
        blk_s = prng.randint(keys[4], shape, 1, PB)
        perm = destinations(pt["pattern"], P)
        if perm is not None:
            base_s = torch.as_tensor(perm, device=dev).expand(shape)
        else:
            base_s = (pes[None, :] + off_s) % P
        ring_peer = pes - pes % RP + (pes % RP + ring_s) % RP
        blk_peer = pes - pes % PB + (pes % PB + blk_s) % PB
        # Both thresholds, and their sum, are float32.
        loc_ring = torch.tensor(np.float32(pt["locality_ringlet"]), **f32)
        loc_both = loc_ring + torch.tensor(np.float32(pt["locality_block"]),
                                           **f32)
        dst_s = torch.where(u_s < loc_ring.to(low), ring_peer,
                            torch.where(u_s < loc_both.to(low), blk_peer,
                                        base_s))
        inj_all.append(inj_s)
        dst_all.append(dst_s.to(torch.int16))
    fault_u = torch.stack(fu_all) if n_faults else None
    return torch.stack(inj_all), torch.stack(dst_all), fault_u


# -- a batch of points on one fabric -----------------------------------------
def simulate(topo: topo_mod.Topology, points: list[dict], cycles: int,
             warmup: int, starvation_limit: int, device,
             precision: str = "float32", trace=None) -> list[dict]:
    """The results of ``points`` (which share their dead links) on
    ``topo``: the program's ``SimResult`` fields, one dict a point.
    ``trace`` (phase destinations and flits, [n_phases, P] int32 each)
    replays those phases at every point; its points draw their streams as
    uniform traffic, which the phase tables then mask and redirect."""
    dead_links = points[0]["dead_links"]
    assert all(p["dead_links"] == dead_links for p in points)
    dev = torch.device(device)
    geom = cycle.build_geometry(topo, dev)
    faults, n_faults = None, 0
    if dead_links:
        links, drop_p, onset = lower(topo, dead_links)
        n_faults = len(links)
        b = len(points)
        faults = tuple(torch.as_tensor(np.stack([a] * b), device=dev)
                       for a in (links, drop_p, onset))
    inj_s, dst_s, fault_u = draw_streams(
        [dict(p, pattern="uniform") if trace is not None else p
         for p in points], topo.n_pes, cycles, n_faults, dev, precision)
    phases = None
    if trace is not None:
        ph_dst, ph_flits = (torch.as_tensor(np.stack([a] * len(points)),
                                            device=dev) for a in trace)
        phases = (ph_dst, ph_flits, ph_flits.sum(dim=2, dtype=torch.int32))
    if faults is not None and precision != "float32":
        faults = (faults[0], faults[1].to(PRECISIONS[precision]).float(),
                  faults[2])
    ql, m_scal, _, _, ph_done = cycle.run_plain(
        geom, inj_s, dst_s, warmup=warmup,
        starvation_limit=starvation_limit, arb_iters=ARB_ITERS,
        trace=phases, faults=faults, fault_u=fault_u)
    in_flight = ql.sum(dim=1, dtype=torch.int64).cpu().numpy()
    m = m_scal.cpu().numpy()
    ph_done = ph_done.cpu().numpy()
    if dead_links:
        dead = dead_queue_mask(topo, dead_links)
        reach = (topo_mod.reachable_fraction(topo, dead) if dead.any()
                 else topo.reachable_frac)
    else:
        reach = topo.reachable_frac
    mc = cycles - warmup
    out = []
    for b in range(len(points)):
        delivered = int(m[b, cycle.DELIVERED])
        out.append(dict(
            topology=topo.name, n_pes=topo.n_pes, delivered=delivered,
            offered=int(m[b, cycle.OFFERED]),
            accepted=int(m[b, cycle.ACCEPTED]),
            dropped=int(m[b, cycle.DROPPED]), lost=int(m[b, cycle.LOST]),
            in_flight=int(np.int32(in_flight[b])), measured_cycles=mc,
            avg_latency=int(m[b, cycle.LAT_SUM]) / max(delivered, 1),
            throughput=delivered / mc,
            flit_hops_per_cycle=int(m[b, cycle.MOVED]) / mc,
            per_pe_throughput=delivered / mc / topo.n_pes,
            phase_done=[int(d) for d in ph_done[b]],
            reachability=reach,
            stall_unretired=int(m[b, cycle.STALL_CREDIT])))
    return out


def report(fabric_cfg: dict, sim: dict) -> dict:
    """One point's joined report: the simulation, the power model at the
    simulated activity, the area and the analytic bounds."""
    fam, n = fabric_cfg["family"], fabric_cfg["n_pes"]
    act = models.activity_from_sim(sim["flit_hops_per_cycle"], n)
    return {"sim": sim, "power": models.power(fam, n, act),
            "area": models.area(fam, n), "analytic": models.analytic(fam, n)}


def run_points(fabric_cfg: dict, topo: topo_mod.Topology,
               points: list[dict], device, precision: str) -> list[dict]:
    """Reports of points on one fabric, batched by what they share (the
    budget and the dead links), in the points' order."""
    groups: dict = {}
    for i, p in enumerate(points):
        key = (p["cycles"], p["warmup"], p["starvation_limit"],
               tuple(p["dead_links"]))
        groups.setdefault(key, []).append(i)
    out: list = [None] * len(points)
    for (cycles, warmup, starve, _), idxs in groups.items():
        sims = simulate(topo, [points[i] for i in idxs], cycles, warmup,
                        starve, device, precision)
        for i, s in zip(idxs, sims):
            out[i] = report(fabric_cfg, s)
    return out


# -- the two entries ---------------------------------------------------------
def grid(request: dict, device, precision: str = "float32") -> dict:
    """A grid of points on the request's fabric."""
    topo = build(request["fabric"])
    return {"reports": run_points(request["fabric"], topo,
                                  request["points"], device, precision)}


def repair(request: dict, device, precision: str = "float32") -> dict:
    """One fault scenario: the healthy, faulted and repaired legs, the
    resilience summary and the repaired fabric's certificate."""
    fab, point, dead = (request["fabric"], request["point"],
                        list(request["dead_links"]))
    healthy_topo = build(fab)
    repaired_topo = build(fab, dead)
    healthy, faulted = run_points(
        fab, healthy_topo, [dict(point, dead_links=[]),
                            dict(point, dead_links=dead)], device, precision)
    repaired, = run_points(fab, repaired_topo, [dict(point, dead_links=[])],
                           device, precision)
    cert = fabric.certify(repaired_topo, fab["queue_depth"],
                          fab["src_queue_depth"], device)
    legs = {"healthy": healthy["sim"], "faulted": faulted["sim"],
            "repaired": repaired["sim"]}
    props = {p["name"]: p for p in cert["properties"]}

    def inflation(leg):
        base = legs["healthy"]["avg_latency"]
        return (round(legs[leg]["avg_latency"] / base, 4) if base > 0
                else math.nan)

    def fraction(s):
        return s["delivered"] / max(s["offered"], 1)

    summary = {
        "scenario": {"dead_links": dead, "dead_routers": [],
                     "transient": []},
        "certified": {
            "ok": cert["ok"],
            "deadlock_free": props["deadlock_free"]["ok"],
            "route_liveness": props["route_liveness"]["ok"],
            "witness": [dict(p["witness"][0]) for p in cert["properties"]
                        if not (p["ok"] or p["waived"]) and p["witness"]]},
        "delivered_fraction": {k: round(fraction(s), 4)
                               for k, s in legs.items()},
        "reachability": {k: round(s["reachability"], 4)
                         for k, s in legs.items()},
        "avg_latency": {k: round(s["avg_latency"], 2)
                        for k, s in legs.items()},
        "latency_inflation": {"faulted": inflation("faulted"),
                              "repaired": inflation("repaired")},
        "repair_gain": round(fraction(legs["repaired"])
                             - fraction(legs["faulted"]), 4),
    }
    return {"reports": [healthy, faulted, repaired], "summary": summary,
            "certificate": cert}
