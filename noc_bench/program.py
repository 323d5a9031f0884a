"""The system under test: the port's NoC entry points, driven with the
generator's requests, and its outputs read back as plain dicts.

Only this module imports the program (``repro_torch``), and only inside
its functions; the entries (``entries/<name>.py``) reach the program
through it.  A request is handed to the program as the objects a
researcher's script builds (``TopologySpec``, ``Experiment``, ``Budget``,
``FaultSpec``, a ``Trace`` from a schedule census) and nothing else: the program derives every table and
stream itself.
"""
from __future__ import annotations

import dataclasses


def modules():
    """The program's modules the benchmark calls or wraps."""
    from repro_torch.analysis import fabric
    from repro_torch.core import experiment, sim, traffic
    from repro_torch.core.spec import TopologySpec
    from repro_torch.faults import repair
    from repro_torch.faults.spec import FaultSpec
    from repro_torch.kernels import noc_step
    from repro_torch.trace import extract
    from repro_torch.trace.spec import Trace
    return dict(fabric=fabric, experiment=experiment, sim=sim,
                traffic=traffic, TopologySpec=TopologySpec, repair=repair,
                FaultSpec=FaultSpec, noc_step=noc_step, extract=extract,
                Trace=Trace)


def load(backend: str) -> None:
    """Load (and at a checkout's first run, build) the kernel."""
    if backend == "cuda":
        modules()["noc_step"].load_library()


def spec(m, fabric_cfg: dict):
    """The configuration's fabric as the researcher's ``TopologySpec``."""
    return m["TopologySpec"](fabric_cfg["family"], fabric_cfg["n_pes"],
                             queue_depth=fabric_cfg["queue_depth"],
                             src_queue_depth=fabric_cfg["src_queue_depth"])


def traffic(m, point: dict):
    return m["traffic"].spec(point["pattern"],
                             locality_ringlet=point["locality_ringlet"],
                             locality_block=point["locality_block"])


def budget(m, point: dict, backend: str, device):
    return m["experiment"].Budget(
        cycles=point["cycles"], warmup=point["warmup"],
        starvation_limit=point["starvation_limit"], backend=backend,
        device=device)


class Captured:
    """What the program produced for one request: its reports, and for a
    fault scenario the summary and the repaired fabric's certificate.
    The entry (``entries/<name>.py``) runs the request; the capture probes
    on ``run_experiments`` and ``fabric.certify`` fill the reports and the
    certificate, so the legs inside an entry are caught as well."""

    def __init__(self):
        self.reports: list = []
        self.summary = None
        self.certificate = None


# -- outputs as plain dicts ---------------------------------------------------
SIM_FIELDS = ("topology", "n_pes", "delivered", "offered", "accepted",
              "dropped", "lost", "in_flight", "measured_cycles",
              "avg_latency", "throughput", "flit_hops_per_cycle",
              "per_pe_throughput", "phase_done", "reachability",
              "stall_unretired")


def report_dict(report) -> dict:
    sim = {k: getattr(report.sim, k) for k in SIM_FIELDS}
    sim["phase_done"] = [int(d) for d in sim["phase_done"]]
    return {"sim": sim, "power": dataclasses.asdict(report.power),
            "area": dataclasses.asdict(report.area),
            "analytic": report.analytic.to_dict()}


def outputs(captured: Captured) -> dict:
    out = {"reports": [report_dict(r) for r in captured.reports]}
    if captured.summary is not None:
        out["summary"] = captured.summary
    if captured.certificate is not None:
        cert = captured.certificate.to_dict()
        out["certificate"] = {k: v for k, v in cert.items()
                              if k not in ("spec", "elapsed_ms")}
    return out


def free() -> None:
    """Drop the program's memoized fabrics, certificates and walks, so the
    reference's peak memory is its own."""
    m = modules()
    m["TopologySpec"].clear_build_cache()
    m["fabric"].clear_certificate_cache()
    m["sim"]._REACH_CACHE.clear()

