"""Write ``tests/data/torch_port_model_reference.json`` from the JAX package.

The anchor for the port's model zoo path at full width: the reference runs
``zamba2-1.2b`` at its published widths (d_model 2048, 64 SSD heads of
width 64 with d_state 64, the shared 32-head attention block with d_ff
8192, vocab 32000) with the depth cut to one 6-layer unit (5 ``mamba`` + 1
``hybrid``, 351 704 832 parameters) and ``attn_impl="xla"``, on the
numpy weights ``repro_torch.models.convert.init_numpy`` draws from
``SEED`` (1.4 GB of float32) and 2 x 256 numpy tokens.  It records the
loss over numpy labels and, at 4 positions per row, the top-10 logits with
their ids, with a fingerprint of the weights so that a rebuild elsewhere
can show it drew the same arrays.  ``chip_smoke.py`` (phase 10) rebuilds
the weights, runs them through the port with its CUDA kernels on the
card, and holds the result to this file.

Run once, from the repo root (about a minute and ~8 GB of memory on a
CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_port_model_reference.py
"""
from __future__ import annotations

import dataclasses
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
UNIT = ("mamba", "mamba", "mamba", "mamba", "mamba", "hybrid")
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port_model_reference.json")


def cut_config():
    """zamba2-1.2b at full width, its depth cut to one unit."""
    return dataclasses.replace(configs.get("zamba2-1.2b"),
                               stages=((UNIT, 1),), n_layers=len(UNIT),
                               attn_impl="xla")


def fingerprint(tree) -> dict:
    """Sums and leading values of a few leaves: enough to show that two
    draws from the seed gave the same arrays."""
    mamba = tree["stages"][0]["0"]["mamba"]
    leaves = {"embed": tree["embed"], "unembed": tree["unembed"],
              "stage0.0.mamba.wx": mamba["wx"],
              "stage0.0.mamba.a_log": mamba["a_log"],
              "shared_attn.attn.wq": tree["shared_attn"]["attn"]["wq"]}
    return {k: {"sum": float(np.sum(v, dtype=np.float64)),
                "head": [float(x) for x in v.reshape(-1)[:4]]}
            for k, v in leaves.items()}


def main() -> None:
    rcfg = cut_config()
    tcfg = convert.config_from_reference(rcfg)
    tree = convert.init_numpy(tcfg, SEED)
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, rcfg.vocab, (BATCH, SEQ))
    labels = rng.integers(0, rcfg.vocab, (BATCH, SEQ))
    params = jax.tree.map(jnp.asarray, tree)
    tok = jnp.asarray(tokens, jnp.int32)
    hidden, *_ = jax.jit(lambda p, t: r_model.forward(rcfg, p, t))(
        params, tok)
    logits = np.asarray(r_model.unembed(rcfg, params, hidden), np.float32)
    loss, _ = jax.jit(lambda p, b: r_model.loss_fn(rcfg, p, b))(
        params, {"tokens": tok, "labels": jnp.asarray(labels, jnp.int32)})
    top = []
    for row in range(BATCH):
        for pos in POSITIONS:
            ids = np.argsort(-logits[row, pos], kind="stable")[:TOP]
            top.append({"row": row, "pos": pos, "ids": ids.tolist(),
                        "logits": logits[row, pos, ids].tolist()})
    ref = {
        "jax_version": jax.__version__,
        "arch": "zamba2-1.2b",
        "cut": {"stages": [[list(UNIT), 1]], "n_layers": len(UNIT),
                "param_count": rcfg.param_count(),
                "note": "full width; depth cut from 38 layers (6 units of "
                        "5 mamba + 1 hybrid, then 2 mamba) to one unit"},
        "attn_impl": rcfg.attn_impl,
        "compute_dtype": "bfloat16",
        "seed": SEED,
        "weights": fingerprint(tree),
        "tokens": tokens.tolist(),
        "labels": labels.tolist(),
        "loss": float(loss),
        "top_logits": top,
    }
    with open(OUT, "w") as f:
        json.dump(ref, f)
        f.write("\n")
    print(f"wrote {OUT}: loss {float(loss):.6f}, "
          f"{rcfg.param_count()} parameters")


if __name__ == "__main__":
    main()
