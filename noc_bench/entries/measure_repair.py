"""A fault scenario request: ``dead_links[i % len]`` dead fabric channels,
placed at random, on the configuration's fabric, with one point
(``patterns[0]``, ``inj_rates[0]``), through ``measure_repair``: the
healthy, faulted and repaired legs and the repaired fabric's
certificate."""
import numpy as np

from noc_bench import generator, program
from noc_bench.reference import noc

LEGS = 3


def context(config: dict, mix: dict) -> dict:
    """The fabric's physical channel ids that a fault may hit (sorted)."""
    return {"channels": noc.fabric_channels(noc.build(config["fabric"]))}


def request(gen, rng, i: int) -> dict:
    counts = gen.mix["dead_links"]
    point = gen.point(gen.mix["patterns"][0], gen.mix["inj_rates"][0],
                      int(rng.integers(0, generator.SEED_MAX)))
    # A seeded draw of distinct fabric channels, as the program's
    # ``faults.sample_faults(topo, n_dead_links=c, seed=s)`` draws them.
    place = np.random.default_rng(int(rng.integers(0, generator.SEED_MAX)))
    dead = place.choice(np.asarray(gen.context["channels"]),
                        size=counts[i % len(counts)], replace=False)
    return dict(entry="measure_repair", fabric=dict(gen.config["fabric"]),
                point=point, dead_links=[int(c) for c in dead])


def run(request: dict, captured, backend: str, device) -> None:
    """The legs' reports and the certificate reach ``captured`` through
    the capture probes; the summary is the entry's return."""
    m = program.modules()
    p = request["point"]
    captured.summary = m["repair"].measure_repair(
        program.spec(m, request["fabric"]),
        m["FaultSpec"](dead_links=tuple(request["dead_links"])),
        traffic=program.traffic(m, p), inj_rate=p["inj_rate"],
        budget=program.budget(m, p, backend, device), seed=p["seed"])


def reference(request: dict, device, precision: str = "float32") -> dict:
    return noc.repair(request, device, precision)


def work(request: dict) -> int:
    return LEGS * request["fabric"]["n_pes"] * request["point"]["cycles"]


def points(request: dict) -> int:
    return LEGS
