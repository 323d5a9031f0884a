"""A grid request: the points of ``patterns`` x ``inj_rates``, each with a
fresh seed, all on the configuration's fabric, in one
``run_experiments`` call.  A pattern or rate listed twice is a second
point with its own seed."""
from noc_bench import generator, program
from noc_bench.reference import noc


def context(config: dict, mix: dict) -> dict:
    return {}


def request(gen, rng, i: int) -> dict:
    points = [gen.point(p, r, int(rng.integers(0, generator.SEED_MAX)))
              for r in gen.mix["inj_rates"] for p in gen.mix["patterns"]]
    return dict(entry="run_experiments", fabric=dict(gen.config["fabric"]),
                points=points)


def run(request: dict, captured, backend: str, device) -> None:
    """The reports reach ``captured`` through the capture probe on
    ``run_experiments``."""
    m = program.modules()
    spec = program.spec(m, request["fabric"])
    exps = [m["experiment"].Experiment(
        topology=spec, traffic=program.traffic(m, p),
        budget=program.budget(m, p, backend, device),
        inj_rate=p["inj_rate"], seed=p["seed"]) for p in request["points"]]
    m["experiment"].run_experiments(exps)


def reference(request: dict, device, precision: str = "float32") -> dict:
    return noc.grid(request, device, precision)


def work(request: dict) -> int:
    """Every point runs ``n_pes`` PEs for the budget's cycles, warm-up
    included."""
    n = request["fabric"]["n_pes"]
    return sum(n * p["cycles"] for p in request["points"])


def points(request: dict) -> int:
    return len(request["points"])
