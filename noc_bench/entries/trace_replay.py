"""A trace-replay request: one mined collective schedule (the mix's
``order``, request ``i`` taking entry ``i mod len``) decomposed into a
phase-gated trace on the configuration's fabric and replayed as one point
in one ``run_experiments`` call.  The program builds the trace in the timed
path from the census, as a researcher's script does
(``extract.schedule_to_trace``, then ``Trace``)."""
from noc_bench import generator, program
from noc_bench.reference import collectives


def context(config: dict, mix: dict) -> dict:
    return {}


def request(gen, rng, i: int) -> dict:
    mix = gen.mix
    name = mix["order"][i % len(mix["order"])]
    point = gen.point(mix["patterns"][0], mix["inj_rates"][0],
                      int(rng.integers(0, generator.SEED_MAX)))
    return dict(entry="trace_replay", fabric=dict(gen.config["fabric"]),
                schedule=name, census=mix["schedules"][name],
                decomposition=dict(mix["decomposition"]), point=point)


def warmups(gen) -> list[dict]:
    """One request of each schedule, so that every phase count the window
    replays has run before it."""
    return [request(gen, generator._rng(gen.seed, 0, k), k)
            for k in range(len(gen.mix["order"]))]


def run(request: dict, captured, backend: str, device) -> None:
    """The report reaches ``captured`` through the capture probe on
    ``run_experiments``."""
    m = program.modules()
    dec, p, n = request["decomposition"], request["point"], \
        request["fabric"]["n_pes"]
    spec = m["extract"].schedule_to_trace(
        request["census"], n, flit_bytes=dec["flit_bytes"],
        normalize_flits=dec["normalize_flits"], algorithm=dec["algorithm"],
        pod_size=(None if request["schedule"] in dec["global"]
                  else dec["pod_size"]),
        label=f"{request['schedule']}@{n}")
    exp = m["experiment"].Experiment(
        topology=program.spec(m, request["fabric"]),
        traffic=m["Trace"](trace=spec),
        budget=program.budget(m, p, backend, device),
        inj_rate=p["inj_rate"], seed=p["seed"])
    m["experiment"].run_experiments([exp])


def reference(request: dict, device, precision: str = "float32") -> dict:
    return collectives.replay(request, device, precision)


def work(request: dict) -> int:
    return request["fabric"]["n_pes"] * request["point"]["cycles"]


def points(request: dict) -> int:
    return 1
