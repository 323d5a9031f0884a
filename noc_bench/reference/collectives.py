"""The plain reference of a trace-replay request: a collective schedule
census decomposed into phase-gated traffic, replayed by the frozen cycle
loop in trace mode.

The decomposition is a plain copy of the textbook step sequence that the
mix names: each collective over a group of ``g`` PEs becomes
``halving_doubling`` steps (log2 g exchanges a scatter or gather, with the
partner at local index XOR distance).  With a ``pod_size``, reduce-scatter
and all-gather run inside contiguous pods and all-reduce across them (one
group per local index); without one, every collective is global.  Byte volumes become flits at ``flit_bytes`` a flit
after dividing by a scale that brings the largest per-PE burst to
``normalize_flits`` flits; any positive volume is at least one flit.
"""
from __future__ import annotations

import math

import numpy as np

from . import noc

KINDS = ("all-reduce", "reduce-scatter", "all-gather")


def _groups(kind: str, n_pes: int, pod_size):
    if pod_size is None:
        return [tuple(range(n_pes))]
    if kind == "all-reduce":
        return [tuple(range(i, n_pes, pod_size)) for i in range(pod_size)]
    return [tuple(range(b, b + pod_size)) for b in range(0, n_pes, pod_size)]


def _xor(groups, dist: int, nbytes: float) -> list:
    return [(src, g[i ^ dist], nbytes)
            for g in groups for i, src in enumerate(g)]


def phases_of(kind: str, groups, nbytes: float, algorithm: str) -> list:
    """One collective as halving-doubling phases of ``(src, dst, bytes)``:
    a reduce-scatter halves the partner distance and the volume each step,
    an all-gather doubles both back, an all-reduce is the one then the
    other."""
    if kind not in KINDS or algorithm != "halving_doubling":
        raise ValueError(f"no decomposition of {kind!r} by {algorithm!r}")
    g = len(groups[0])
    bits = g.bit_length() - 1
    if (1 << bits) != g:
        raise ValueError(f"halving_doubling needs a power-of-two group, "
                         f"got {g}")
    out = []
    if kind in ("reduce-scatter", "all-reduce"):
        out += [_xor(groups, g >> k, nbytes / (1 << k))
                for k in range(1, bits + 1)]
    if kind in ("all-gather", "all-reduce"):
        out += [_xor(groups, 1 << (k - 1), nbytes / (1 << (bits - k + 1)))
                for k in range(1, bits + 1)]
    return out


def byte_phases(census: dict, n_pes: int, algorithm: str, pod_size) -> list:
    """The census's collectives in its own order, each aggregated into one
    collective of its total bytes."""
    out = []
    for kind, nbytes in census["bytes_by_kind"].items():
        if nbytes > 0:
            out += phases_of(kind, _groups(kind, n_pes, pod_size), nbytes,
                             algorithm)
    return out


def flit_phases(phases: list, flit_bytes: int, normalize_flits: int) -> list:
    """Bytes to flits, the largest burst scaled to ``normalize_flits``."""
    peak = max(b for ph in phases for _, _, b in ph)
    scale = max(1.0, peak / (flit_bytes * normalize_flits))
    return [[(s, d, max(1, math.ceil(b / (flit_bytes * scale))))
             for s, d, b in ph] for ph in phases]


def tables(request: dict) -> tuple[np.ndarray, np.ndarray]:
    """The request's phase tables, destinations and flits [n_phases, P]
    int32 (an idle source carries 0 flits)."""
    n = request["fabric"]["n_pes"]
    dec = request["decomposition"]
    pod = None if request["schedule"] in dec["global"] else dec["pod_size"]
    phases = flit_phases(byte_phases(request["census"], n,
                                     dec["algorithm"], pod),
                         dec["flit_bytes"], dec["normalize_flits"])
    dst = np.zeros((len(phases), n), np.int32)
    flits = np.zeros((len(phases), n), np.int32)
    for i, ph in enumerate(phases):
        for s, d, f in ph:
            dst[i, s], flits[i, s] = d, f
    return dst, flits


def replay(request: dict, device, precision: str = "float32") -> dict:
    """The request's one point replayed on its fabric, and its report."""
    fab, point = request["fabric"], request["point"]
    sim, = noc.simulate(noc.build(fab), [point], point["cycles"],
                        point["warmup"], point["starvation_limit"], device,
                        precision, trace=tables(request))
    return {"reports": [noc.report(fab, sim)]}
