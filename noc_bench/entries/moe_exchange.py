"""An expert-parallel exchange request: one MoE layer's decode-step
dispatch and combine on the configuration's fabric, request ``i`` routing
through MoE layer ``first_k_dense_replace + (i mod n_moe_layers)``.

The program routes fresh tokens (hidden states from the point's seed) with
the layer's router (weights from the run's seed and the layer index) and
lays the routing out as a two-phase trace in records form
(``extract.moe_exchange_trace``), in the timed path, then replays it as one
point in one ``run_experiments`` call.  The routing summary reaches
``captured.summary``; the report, the capture probe on
``run_experiments``.  Its reference is ``reference/moe.py``."""
from noc_bench import generator, program
from noc_bench.reference import moe

ROUTER_KEYS = ("hidden_size", "n_routed_experts", "num_experts_per_tok",
               "n_group", "topk_group", "routed_scaling_factor",
               "norm_topk_prob")


def context(config: dict, mix: dict) -> dict:
    return {}


def request(gen, rng, i: int) -> dict:
    cfg, mix = gen.config, gen.mix
    first = cfg["first_k_dense_replace"]
    layer = first + i % (cfg["num_hidden_layers"] - first)
    # The router's stream word is its own: the check's sample draws from
    # word 2.
    base = int(generator._rng(gen.seed, 3).integers(0, generator.SEED_MAX))
    point = gen.point(mix["patterns"][0], mix["inj_rates"][0],
                      int(rng.integers(0, generator.SEED_MAX)))
    return dict(entry="moe_exchange", fabric=dict(cfg["fabric"]),
                model={k: cfg[k] for k in ROUTER_KEYS}, layer=layer,
                router_seed=base * 256 + layer,
                tokens_per_pe=mix["tokens_per_pe"],
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
        label=f"moe_layer{request['layer']}@{n}")
    exp = m["experiment"].Experiment(
        topology=program.spec(m, request["fabric"]), traffic=trace,
        budget=program.budget(m, p, backend, device),
        inj_rate=p["inj_rate"], seed=p["seed"])
    m["experiment"].run_experiments([exp])


def reference(request: dict, device, precision: str = "float32") -> dict:
    return moe.replay(request, device, precision)


def work(request: dict) -> int:
    return request["fabric"]["n_pes"] * request["point"]["cycles"]


def points(request: dict) -> int:
    return 1
