"""A zero-compute-expert exchange request: one LongCat-Flash MoE layer's
decode-step dispatch and combine on the configuration's fabric, request
``i`` routing through MoE layer ``i mod num_layers`` (one MoE a layer).

The program draws the layer's topic vectors and router (from the run's
seed and the layer index) and fresh topic-skewed tokens (from the point's
seed), routes them with the softmax router over the real and identity
experts and lays the routing out as a two-phase trace in records form
(``extract.moe_exchange_trace`` with ``topics``), in the timed path, then
replays it as one point in one ``run_experiments`` call.  The routing
summary reaches ``captured.summary``; the report, the capture probe on
``run_experiments``.  Its reference is ``reference/moe_zero.py``."""
from noc_bench import generator, program
from noc_bench.reference import moe_zero

ROUTER_KEYS = ("hidden_size", "n_routed_experts", "zero_expert_num",
               "zero_expert_type", "moe_topk", "routed_scaling_factor")


def context(config: dict, mix: dict) -> dict:
    return {}


def request(gen, rng, i: int) -> dict:
    cfg, mix = gen.config, gen.mix
    layer = i % cfg["num_layers"]
    # The router's stream word is its own: the check's sample draws from
    # word 2.
    base = int(generator._rng(gen.seed, 3).integers(0, generator.SEED_MAX))
    point = gen.point(mix["patterns"][0], mix["inj_rates"][0],
                      int(rng.integers(0, generator.SEED_MAX)))
    return dict(entry="moe_zero_exchange", fabric=dict(cfg["fabric"]),
                model={k: cfg[k] for k in ROUTER_KEYS}, layer=layer,
                router_seed=base * 256 + layer,
                tokens_per_pe=mix["tokens_per_pe"], topics=mix["topics"],
                dispatch_bytes=cfg["token_bytes"]["dispatch"],
                combine_bytes=cfg["token_bytes"]["combine"],
                flits=dict(mix["flits"]), point=point)


def run(request: dict, captured, backend: str, device) -> None:
    m = program.modules()
    p, n = request["point"], request["fabric"]["n_pes"]
    fl = request["flits"]
    trace, captured.summary = m["extract"].moe_exchange_trace(
        request["model"], n, request["tokens_per_pe"],
        dispatch_bytes=request["dispatch_bytes"],
        combine_bytes=request["combine_bytes"],
        router_seed=request["router_seed"], token_seed=p["seed"],
        device=device, flit_bytes=fl["flit_bytes"], scale=fl["scale"],
        label=f"moe_layer{request['layer']}@{n}", topics=request["topics"])
    exp = m["experiment"].Experiment(
        topology=program.spec(m, request["fabric"]), traffic=trace,
        budget=program.budget(m, p, backend, device),
        inj_rate=p["inj_rate"], seed=p["seed"])
    m["experiment"].run_experiments([exp])


def reference(request: dict, device, precision: str = "float32") -> dict:
    return moe_zero.replay(request, device, precision)


def work(request: dict) -> int:
    return request["fabric"]["n_pes"] * request["point"]["cycles"]


def points(request: dict) -> int:
    return 1
