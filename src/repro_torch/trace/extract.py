"""Trace extraction: collective schedules / dist layer / HLO -> TraceSpec.

Three front ends produce the same ``TraceSpec`` phase representation, and
a fourth, ``moe_exchange_trace`` (``trace.moe``), a ``TraceRecords``:

* ``schedule_to_trace`` — a collective *schedule census* (the format of
  ``experiments/hillclimb/collective_schedules.json`` and of
  ``launch.hlo.collective_bytes``: per-kind byte and op counts) decomposed
  into per-step communication phases;
* ``dist_to_trace`` — the ``repro.dist.data_parallel`` gradient-reduction
  schedules (``flat`` / ``hier`` / ``hier_int8``) stated directly from
  their semantics (reduce-scatter in-pod, all-reduce across pods,
  all-gather back; int8 compresses the pod hop 4x);
* ``hlo_to_trace`` — a post-SPMD HLO dump via ``launch.hlo``'s per-op
  census, covering ``collective-permute`` (ring decode attention's
  ``ppermute`` steps, with explicit ``source_target_pairs`` destination
  maps) and ``all-to-all`` alongside the reduction collectives;
* ``moe_exchange_trace`` — one MoE layer's decode-step routing on the
  device (DeepSeek-V3's group-limited router, or LongCat-Flash's softmax
  over real and identity experts, by the model's keys; iid or
  topic-skewed tokens), its expert-parallel dispatch and combine as two
  phases in which a source sends to many experts.

``schedule_to_trace`` and the layout of ``moe_exchange_trace`` are the
``trace.build`` span while telemetry is on.

Decomposition: each collective over a group of ``g`` PEs becomes its
textbook step sequence — ``ring`` (g-1 neighbour-shift steps per
scatter/gather, bandwidth-optimal) or ``halving_doubling`` (log2 g
recursive-doubling exchanges, latency-optimal; power-of-two groups only).
Hierarchical schedules pass ``pod_size``: reduce-scatter / all-gather run
*inside* contiguous pods (every pod concurrently in the same phase) while
all-reduce runs *across* pods (a group per local index, so cross-pod
steps hop ``pod_size`` PEs — long-range mesh traffic, exactly the
ring-then-mesh shaping of DESIGN.md §9).

Byte volumes convert to flits with the trace's explicit ``flit_bytes``
(``spec.FLIT_BYTES`` default) and an optional ``scale`` divisor;
``normalize_flits`` picks the scale automatically so the largest per-PE
phase burst is a given flit count (the chosen scale is recorded on the
returned ``TraceSpec``).
"""
from __future__ import annotations

import json
import math
import os
from typing import Optional, Sequence

from repro_torch import telemetry
from repro_torch.trace.spec import (FLIT_BYTES, Trace, TraceSpec,
                                    flits_for_bytes)

#: Collective kinds the decomposer understands (census keys).
KNOWN_KINDS = ("all-reduce", "reduce-scatter", "all-gather", "all-to-all",
               "collective-permute")

ALGORITHMS = ("ring", "halving_doubling")

#: Path of the repo's mined collective schedules (three DP gradient
#: reduction schedules: flat, hier, hier_int8).
SCHEDULES_JSON = os.path.join("experiments", "hillclimb",
                              "collective_schedules.json")


def _check_pow2(g: int, what: str) -> int:
    bits = g.bit_length() - 1
    if (1 << bits) != g:
        raise ValueError(f"halving_doubling needs a power-of-two group "
                         f"size for {what}, got {g}")
    return bits


def _groups_global(n_pes: int) -> list[tuple[int, ...]]:
    return [tuple(range(n_pes))]


def _groups_in_pod(n_pes: int, pod_size: int) -> list[tuple[int, ...]]:
    """Contiguous pods: [0..ps), [ps..2ps), ..."""
    return [tuple(range(b, b + pod_size))
            for b in range(0, n_pes, pod_size)]


def _groups_cross_pod(n_pes: int, pod_size: int) -> list[tuple[int, ...]]:
    """One group per local index: PEs {l, l+ps, l+2ps, ...} — cross-pod
    steps are long-range (stride ``pod_size``) traffic."""
    return [tuple(range(l, n_pes, pod_size)) for l in range(pod_size)]


def _shift_phase(groups, offset: int, nbytes: float) -> list:
    """One ring step: every member sends to the member ``offset`` ahead."""
    recs = []
    for g in groups:
        n = len(g)
        for i, src in enumerate(g):
            recs.append((src, g[(i + offset) % n], nbytes))
    return recs


def _xor_phase(groups, dist: int, nbytes: float) -> list:
    """One recursive-doubling exchange: partner = local index XOR dist."""
    recs = []
    for g in groups:
        for i, src in enumerate(g):
            recs.append((src, g[i ^ dist], nbytes))
    return recs


def collective_phases(kind: str, groups: Sequence[tuple[int, ...]],
                      nbytes: float, algorithm: str = "ring") -> list[list]:
    """Decompose one collective into phases of ``(src, dst, bytes)``.

    ``groups`` are the disjoint participant groups (all the same size;
    every group runs its steps concurrently, phase-aligned).  ``nbytes``
    is the full per-group tensor volume the collective reduces/gathers.
    Raises ``ValueError`` (never ``KeyError``) on unknown kinds.
    """
    if kind not in KNOWN_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}; "
                         f"known kinds: {KNOWN_KINDS}")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"one of {ALGORITHMS}")
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError(f"mixed group sizes {sorted(sizes)}")
    g = sizes.pop()
    if g < 2:
        raise ValueError("collective groups need >= 2 members")

    def rs_ring():
        return [_shift_phase(groups, 1, nbytes / g) for _ in range(g - 1)]

    def rs_hd():
        bits = _check_pow2(g, kind)
        return [_xor_phase(groups, g >> k, nbytes / (1 << k))
                for k in range(1, bits + 1)]

    def ag_ring():
        return [_shift_phase(groups, 1, nbytes / g) for _ in range(g - 1)]

    def ag_hd():
        bits = _check_pow2(g, kind)
        return [_xor_phase(groups, 1 << (k - 1),
                           nbytes / (1 << (bits - k + 1)))
               for k in range(1, bits + 1)]

    ring = algorithm == "ring"
    if kind == "reduce-scatter":
        return rs_ring() if ring else rs_hd()
    if kind == "all-gather":
        return ag_ring() if ring else ag_hd()
    if kind == "all-reduce":
        return (rs_ring() + ag_ring()) if ring else (rs_hd() + ag_hd())
    if kind == "all-to-all":
        # offset-k exchanges: each member sends a 1/g slice to everyone
        # else (algorithm-independent).
        return [_shift_phase(groups, k, nbytes / g) for k in range(1, g)]
    # collective-permute: one neighbour-shift phase of the full payload
    # (explicit source_target_pairs go through ``permute_phase``).
    return [_shift_phase(groups, 1, nbytes)]


def permute_phase(pairs: Sequence[tuple[int, int]], n_pes: int,
                  nbytes: float) -> list[list]:
    """Phases for an explicit ``collective-permute`` pair list.  Sources
    appearing multiple times are split into sub-phases (conservative:
    sub-phases serialize); self-pairs are dropped (they move no flits)."""
    waves: list[dict] = []
    for s, d in pairs:
        if not (0 <= s < n_pes and 0 <= d < n_pes):
            raise ValueError(f"permute pair ({s}, {d}) out of range for "
                             f"{n_pes} PEs")
        if s == d:
            continue
        for w in waves:
            if s not in w:
                w[s] = d
                break
        else:
            waves.append({s: d})
    if not waves:
        raise ValueError("collective-permute pairs move no data "
                         "(all self-pairs or empty)")
    return [[(s, d, nbytes) for s, d in sorted(w.items())] for w in waves]


def _to_spec(byte_phases: list[list], n_pes: int, *, flit_bytes: int,
             scale: float, normalize_flits: Optional[int],
             label: str) -> TraceSpec:
    """Byte-valued phases -> TraceSpec, resolving the flit scale."""
    if not byte_phases:
        raise ValueError(f"schedule {label!r} produced no phases")
    if normalize_flits is not None:
        if normalize_flits < 1:
            raise ValueError("normalize_flits must be >= 1")
        peak = max(b for ph in byte_phases for _, _, b in ph)
        scale = max(scale, peak / (flit_bytes * normalize_flits))
    phases = tuple(
        tuple((s, d, flits_for_bytes(b, flit_bytes, scale))
              for s, d, b in ph)
        for ph in byte_phases)
    return TraceSpec(n_pes=n_pes, phases=phases, flit_bytes=flit_bytes,
                     scale=scale, label=label)


@telemetry.spanned("trace.build")
def schedule_to_trace(schedule: dict, n_pes: int, *,
                      flit_bytes: int = FLIT_BYTES, scale: float = 1.0,
                      normalize_flits: Optional[int] = None,
                      algorithm: str = "ring",
                      pod_size: Optional[int] = None,
                      per_op: bool = False, label: str = "") -> TraceSpec:
    """A collective schedule census -> dependency-chained TraceSpec.

    ``schedule`` has the ``collective_schedules.json`` /
    ``hlo.collective_bytes`` shape: ``{"bytes_by_kind": {kind: bytes},
    "count_by_kind": {kind: n}}``.  Kinds are emitted in the census's own
    (insertion) order — for the mined schedules that is the execution
    order of the DP reduction.  ``per_op=False`` aggregates each kind into
    one collective of its total bytes; ``per_op=True`` emits ``count``
    chained repetitions of ``bytes/count`` each (finer dependency
    structure, proportionally more phases).  ``pod_size`` makes
    reduce-scatter / all-gather pod-local and all-reduce cross-pod (the
    hierarchical schedules); ``None`` keeps every collective global.
    """
    if "bytes_by_kind" not in schedule:
        raise ValueError(
            "schedule must carry 'bytes_by_kind' (the "
            "collective_schedules.json / hlo.collective_bytes shape); "
            f"got keys {sorted(schedule)}")
    if pod_size is not None:
        if pod_size < 2 or n_pes % pod_size or pod_size >= n_pes:
            raise ValueError(
                f"pod_size {pod_size} must be >= 2, < n_pes and divide "
                f"n_pes ({n_pes})")
    counts = schedule.get("count_by_kind", {})
    byte_phases: list[list] = []
    for kind, nbytes in schedule["bytes_by_kind"].items():
        if kind not in KNOWN_KINDS:
            raise ValueError(
                f"unknown collective kind {kind!r} in schedule "
                f"{label or '<unlabeled>'!r}; known kinds: {KNOWN_KINDS}")
        if nbytes <= 0:
            continue
        if pod_size is None:
            groups = _groups_global(n_pes)
        elif kind == "all-reduce":
            groups = _groups_cross_pod(n_pes, pod_size)
        else:
            groups = _groups_in_pod(n_pes, pod_size)
        reps = max(int(counts.get(kind, 1)), 1) if per_op else 1
        per_bytes = nbytes / reps
        # per-group tensor volume: the census counts per-device bytes of
        # the full tensor, which is what each group reduces.
        for _ in range(reps):
            byte_phases.extend(collective_phases(kind, groups, per_bytes,
                                                 algorithm))
    return _to_spec(byte_phases, n_pes, flit_bytes=flit_bytes, scale=scale,
                    normalize_flits=normalize_flits, label=label)


# ---------------------------------------------------------------------------
# Front end 2: straight from the repro.dist schedule semantics.
# ---------------------------------------------------------------------------
DIST_SCHEDULES = ("flat", "hier", "hier_int8")


def dist_to_trace(schedule: str, n_pes: int, grad_bytes: float, *,
                  pod_size: int = 16, **kw) -> TraceSpec:
    """The ``dist.data_parallel`` gradient-reduction schedules as traces.

    * ``flat`` — one all-reduce of the full gradient over all PEs.
    * ``hier`` — ``collectives.hierarchical_psum``: reduce-scatter in-pod,
      all-reduce of the 1/pod_size shard across pods, all-gather in-pod.
    * ``hier_int8`` — ``compression.compressed_psum`` on the pod hop:
      exact in-pod all-reduce, then the int8 codes (1/4 the bytes)
      all-gathered across pods.

    ``**kw`` forwards to ``schedule_to_trace`` (flit size, scale,
    algorithm, ...).
    """
    if schedule not in DIST_SCHEDULES:
        raise ValueError(f"unknown dist schedule {schedule!r}; "
                         f"one of {DIST_SCHEDULES}")
    label = kw.pop("label", f"dist_{schedule}")
    if schedule == "flat":
        census = {"bytes_by_kind": {"all-reduce": grad_bytes}}
        return schedule_to_trace(census, n_pes, label=label, **kw)
    if schedule == "hier":
        census = {"bytes_by_kind": {
            "reduce-scatter": grad_bytes,
            "all-reduce": grad_bytes / pod_size,
            "all-gather": grad_bytes / pod_size}}
        return schedule_to_trace(census, n_pes, pod_size=pod_size,
                                 label=label, **kw)
    census = {"bytes_by_kind": {
        "all-reduce": grad_bytes,          # exact in-pod psum
        "all-gather": grad_bytes / 4}}     # int8 codes across pods
    # the int8 pod hop is the *cross-pod* collective here, so swap the
    # group roles: all-reduce in-pod, all-gather across pods.
    if pod_size < 2 or n_pes % pod_size or pod_size >= n_pes:
        raise ValueError(f"pod_size {pod_size} must divide n_pes ({n_pes})")
    byte_phases: list[list] = []
    algorithm = kw.pop("algorithm", "ring")
    flit_bytes = kw.pop("flit_bytes", FLIT_BYTES)
    scale = kw.pop("scale", 1.0)
    normalize_flits = kw.pop("normalize_flits", None)
    if kw:
        raise TypeError(f"unexpected arguments: {sorted(kw)}")
    byte_phases.extend(collective_phases(
        "all-reduce", _groups_in_pod(n_pes, pod_size), grad_bytes,
        algorithm))
    byte_phases.extend(collective_phases(
        "all-gather", _groups_cross_pod(n_pes, pod_size), grad_bytes / 4,
        algorithm))
    return _to_spec(byte_phases, n_pes, flit_bytes=flit_bytes, scale=scale,
                    normalize_flits=normalize_flits, label=label)


# ---------------------------------------------------------------------------
# Front end 3: post-SPMD HLO dumps (launch.hlo per-op census).
# ---------------------------------------------------------------------------
def hlo_to_trace(hlo_text: str, n_pes: int, *,
                 flit_bytes: int = FLIT_BYTES, scale: float = 1.0,
                 normalize_flits: Optional[int] = None,
                 algorithm: str = "ring", label: str = "hlo") -> TraceSpec:
    """An optimized HLO dump -> TraceSpec, op by op in program order.

    Reduction collectives decompose like ``schedule_to_trace`` (replica
    group *size* maps to contiguous pods when it divides ``n_pes``);
    ``collective-permute`` ops use their explicit ``source_target_pairs``
    as the phase destination map — ring decode attention's ``ppermute``
    chain replays exactly — and ``all-to-all`` becomes its g-1 offset
    exchanges.
    """
    from repro_torch.launch import hlo as hlo_mod

    ops = hlo_mod.collective_ops(hlo_text)
    if not ops:
        raise ValueError("HLO text contains no collective ops")
    byte_phases: list[list] = []
    for op in ops:
        kind, nbytes, gs = op["kind"], op["bytes"], op["group_size"]
        if nbytes <= 0:
            continue
        if kind == "collective-permute" and op.get("pairs"):
            pairs = [(s, d) for s, d in op["pairs"]
                     if s < n_pes and d < n_pes]
            if pairs:
                byte_phases.extend(permute_phase(pairs, n_pes, nbytes))
                continue
        if 2 <= gs < n_pes and n_pes % gs == 0:
            groups = _groups_in_pod(n_pes, gs)
        else:
            groups = _groups_global(n_pes)
        byte_phases.extend(collective_phases(kind, groups, nbytes,
                                             algorithm))
    return _to_spec(byte_phases, n_pes, flit_bytes=flit_bytes, scale=scale,
                    normalize_flits=normalize_flits, label=label)


# ---------------------------------------------------------------------------
# The mined schedule file.
# ---------------------------------------------------------------------------
def load_schedules(path: str = SCHEDULES_JSON) -> dict[str, dict]:
    """Load and validate a ``collective_schedules.json`` file: a mapping
    of schedule name -> census.  Unknown collective kinds fail here with
    the full kind list (not a ``KeyError`` deep in the decomposer)."""
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict) or not raw:
        raise ValueError(f"{path}: expected a non-empty mapping of "
                         f"schedule name -> census")
    for name, census in raw.items():
        if not isinstance(census, dict) or "bytes_by_kind" not in census:
            raise ValueError(
                f"{path}: schedule {name!r} lacks 'bytes_by_kind' "
                f"(got keys {sorted(census) if isinstance(census, dict) else type(census).__name__})")
        for kind, nbytes in census["bytes_by_kind"].items():
            if kind not in KNOWN_KINDS:
                raise ValueError(
                    f"{path}: schedule {name!r} uses unknown collective "
                    f"kind {kind!r}; known kinds: {KNOWN_KINDS}")
            if not isinstance(nbytes, (int, float)) or nbytes < 0:
                raise ValueError(
                    f"{path}: schedule {name!r} kind {kind!r} has invalid "
                    f"byte count {nbytes!r}")
    return raw


def traces_for_schedules(n_pes: int, path: str = SCHEDULES_JSON, *,
                         pod_size: int = 16, algorithm: str =
                         "halving_doubling",
                         normalize_flits: Optional[int] = 8,
                         flit_bytes: int = FLIT_BYTES) -> dict[str, Trace]:
    """Every schedule in ``path`` as a ready-to-run ``Trace`` traffic
    spec for ``n_pes`` PEs (the benchmark/quickstart entry point).  The
    ``flat`` schedule runs global; the hierarchical ones use ``pod_size``
    (clamped out when it does not divide ``n_pes``)."""
    out = {}
    hier_pod = pod_size if (n_pes % pod_size == 0
                            and 2 <= pod_size < n_pes) else None
    for name, census in load_schedules(path).items():
        ps = None if name == "flat" else hier_pod
        spec = schedule_to_trace(
            census, n_pes, pod_size=ps, algorithm=algorithm,
            normalize_flits=normalize_flits, flit_bytes=flit_bytes,
            label=f"{name}@{n_pes}")
        out[name] = Trace(trace=spec)
    return out


def completion_budget(trace: TraceSpec, topology_diameter: int = 64,
                      slack: float = 2.0) -> int:
    """A cycle budget comfortably above the trace's critical path: every
    phase needs at least its largest per-PE burst plus network drain."""
    per_phase = sum(max(f for _, _, f in ph) + topology_diameter + 8
                    for ph in trace.phases)
    return int(math.ceil(per_phase * slack)) + 64


# ---------------------------------------------------------------------------
# Front end 4: a mixture-of-experts layer's expert-parallel exchange.
# ---------------------------------------------------------------------------
from repro_torch.trace.moe import moe_exchange_trace  # noqa: E402
