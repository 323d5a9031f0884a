"""The yardstick of the device's work: published peaks of one H100 and the
least operations and bytes of one ``noc_step`` launch, from shapes alone.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: 3.35
TB/s of HBM and 67 TFLOP/s of float32 outside the tensor cores.  The
kernel's work is int32 ALU, for which the data sheet gives no rate, so the
float32 scalar rate stands in for it.

The count is ``chip_smoke.bound_ms``'s arithmetic with two changes, so
that it reads only the launch's shapes (the route, candidate and fan-in
tables, the batch, the cycles, the trace phases and fault entries) and
nothing the kernel reports about its own run:

* one arbitration pass per cycle and point, the least a cycle needs,
  where ``bound_ms`` counted the kernel's own passes;
* no compare per moved flit under faults: the moves are the run's own
  count.

A faster kernel that needs fewer passes therefore cannot lower its own
bound, and the share stays a lower bound of the real one.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def launch_shape(geom, inj_s, trace=None, faults=None) -> dict:
    """The shapes of one ``run_fused`` launch that the count reads."""
    lp1, p = geom.route.shape
    np1, fc = geom.cand.shape
    batch, cycles, _ = inj_s.shape
    return dict(lp1=int(lp1), p=int(p), np1=int(np1), fc=int(fc),
                fi=int(geom.intab.shape[1]), batch=int(batch),
                cycles=int(cycles),
                n_phases=0 if trace is None else int(trace[0].shape[1]),
                n_faults=0 if faults is None else int(faults[0].shape[1]))


def stream_bytes(s: dict) -> int:
    """Bytes of the pregenerated streams: injections (bool) and
    destinations (int16) [B, cycles, P], and the fault draws (float32)
    [B, cycles, F]."""
    return s["batch"] * s["cycles"] * (s["p"] * 3 + s["n_faults"] * 4)


def kernel_bytes(s: dict) -> int:
    """Each input byte read once and each output byte written once."""
    lp1, p, np1, fc, fi = s["lp1"], s["p"], s["np1"], s["fc"], s["fi"]
    b, n_ph, n_f = s["batch"], s["n_phases"], s["n_faults"]
    tables = (lp1 * p * 2 + lp1 * (5 * 4 + 1) + p * 4 + np1 * fc * 4
              + lp1 * fi * 4)
    outputs = b * (lp1 * 4 + 8 * 4 + 24 * 4 + 4)
    trace_bytes = b * n_ph * (2 * p * 4 + 4 + 4)
    fault_entries = b * n_f * 12
    return stream_bytes(s) + tables + outputs + trace_bytes + fault_entries


def kernel_ops(s: dict) -> int:
    """Per cycle and row: route and score (12), dequeue and counts (14),
    fan-in enqueue and injection (4 per entry + 12); per arbitration pass
    (one a cycle and point): the channel row-max (4 per candidate + 2),
    winners, feasibility and the active update (12 per row); trace: the
    phase gate and sent count per PE (4) and the barrier (10) a cycle;
    faults: each entry's active flag (3) a cycle."""
    lp1, p, np1, fc, fi = s["lp1"], s["p"], s["np1"], s["fc"], s["fi"]
    per_cycle = lp1 * (12 + 14 + 4 * fi + 12)
    if s["n_phases"]:
        per_cycle += 4 * p + 10
    per_cycle += 3 * s["n_faults"]
    per_pass = np1 * (4 * fc + 2) + lp1 * 12
    return s["batch"] * s["cycles"] * (per_cycle + per_pass)


def kernel_bound_s(s: dict) -> float:
    """Least seconds of the launch: the larger of its bytes at the memory
    rate and its operations at the scalar rate."""
    return max(kernel_bytes(s) / HBM_BYTES_PER_S,
               kernel_ops(s) / SCALAR_OPS_PER_S)


def job_bound_s(s: dict) -> float:
    """Least seconds of the launch's share of a request: the kernel's
    bound plus writing its streams once."""
    return kernel_bound_s(s) + stream_bytes(s) / HBM_BYTES_PER_S
