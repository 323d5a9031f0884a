"""Write ``tests/data/torch_port_zoo_reference.json`` from the JAX package.

The anchor for the port's decoder-only model zoo at full width: the
reference runs one layer of each of qwen2-7b (GQA 28/4, head width 128,
QKV bias), h2o-danube-1.8b (GQA 32/8, head width 80, window 4 096),
mamba2-1.3b (64 SSD heads of width 64, d_state 128) and
phi3.5-moe-42b-a6.6b (16 experts of d_ff 6 400, top-2) at its published
widths, vocabularies included, with ``attn_impl="xla"`` and bfloat16
compute as shipped, on the numpy weights
``repro_torch.models.convert.init_numpy`` draws from ``SEED`` and 2 x 256
numpy tokens.  For each it records the loss (and the MoE auxiliary loss)
over numpy labels, the top-10 logits with their ids at 4 positions per
row, for phi3.5-moe the experts each token is routed to, and a
fingerprint of the weights, so that a rebuild elsewhere can show it drew
the same arrays.  ``chip_smoke.py`` (phase 14) rebuilds the weights, runs
them through the port with its CUDA kernels on the card, and holds the
result to this file.

Run once, from the repo root (about two minutes on a CPU; one model at a
time, at most ~20 GB of memory, phi3.5-moe's layer):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_port_zoo_reference.py
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs
from repro.models import model as r_model
from repro_torch.models import convert

SEED = 0
BATCH, SEQ = 2, 256
POSITIONS = (0, 85, 170, 255)
TOP = 10
ARCHS = ("qwen2-7b", "h2o-danube-1.8b", "mamba2-1.3b",
         "phi3.5-moe-42b-a6.6b")
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port_zoo_reference.json")


def cut_config(arch: str):
    """The architecture at full width, its depth cut to one layer."""
    cfg = configs.get(arch)
    unit = cfg.stages[0][0]
    return dataclasses.replace(cfg, stages=((unit, 1),), n_layers=len(unit),
                               attn_impl="xla")


def fingerprint(tree) -> dict:
    """Sums and leading values of the embeddings and of every leaf of the
    layer: enough to show that two draws from the seed gave the same
    arrays."""
    leaves = {"embed": tree["embed"], "unembed": tree["unembed"]}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree["stages"][0])
    for path, v in flat:
        leaves["stage0." + ".".join(str(getattr(k, "key", k))
                                    for k in path)] = v
    return {k: {"sum": float(np.sum(v, dtype=np.float64)),
                "head": [float(x) for x in v.reshape(-1)[:4]]}
            for k, v in leaves.items()}


def run(arch: str) -> dict:
    rcfg = cut_config(arch)
    tcfg = convert.config_from_reference(rcfg)
    tree = convert.init_numpy(tcfg, SEED)
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, rcfg.vocab, (BATCH, SEQ))
    labels = rng.integers(0, rcfg.vocab, (BATCH, SEQ))
    params = jax.tree.map(jnp.asarray, tree)
    tok = jnp.asarray(tokens, jnp.int32)
    routed: list = []
    top_k = jax.lax.top_k

    def recording_top_k(gates, k):
        vals, idx = top_k(gates, k)
        jax.debug.callback(lambda i: routed.append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx
    jax.lax.top_k = recording_top_k
    try:
        hidden, *_ = jax.jit(lambda p, t: r_model.forward(rcfg, p, t))(
            params, tok)
        jax.effects_barrier()
    finally:
        jax.lax.top_k = top_k
    logits = np.asarray(r_model.unembed(rcfg, params, hidden), np.float32)
    loss, parts = jax.jit(lambda p, b: r_model.loss_fn(rcfg, p, b))(
        params, {"tokens": tok, "labels": jnp.asarray(labels, jnp.int32)})
    top = []
    for row in range(BATCH):
        for pos in POSITIONS:
            ids = np.argsort(-logits[row, pos], kind="stable")[:TOP]
            top.append({"row": row, "pos": pos, "ids": ids.tolist(),
                        "logits": logits[row, pos, ids].tolist()})
    unit = rcfg.stages[0][0]
    out = {
        "cut": {"stages": [[list(unit), 1]], "n_layers": len(unit),
                "param_count": rcfg.param_count(),
                "note": f"full width; depth cut from "
                        f"{configs.get(arch).n_layers} layers to one"},
        "weights": fingerprint(tree),
        "tokens": tokens.tolist(),
        "labels": labels.tolist(),
        "loss": float(loss),
        "aux": float(parts["aux"]),
        "top_logits": top,
    }
    if routed:
        out["experts"] = routed[0].reshape(BATCH, SEQ, -1).tolist()
    print(f"{arch}: loss {float(loss):.6f}, aux {float(parts['aux']):.6f}, "
          f"{rcfg.param_count()} parameters", flush=True)
    return out


def main() -> None:
    ref = {"jax_version": jax.__version__, "attn_impl": "xla",
           "compute_dtype": "bfloat16", "seed": SEED, "models": {}}
    for arch in ARCHS:
        ref["models"][arch] = run(arch)
        gc.collect()
    with open(OUT, "w") as f:
        json.dump(ref, f)
        f.write("\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
