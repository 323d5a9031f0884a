"""Write ``tests/data/torch_port_cross_reference.json`` from the JAX package.

The anchor for the port's cross-attention and encoder at full width.  The
reference runs, with ``attn_impl="xla"`` (its own route at these lengths:
its Pallas kernel asserts that 1 500 and 1 600 rows tile by 128, and they
do not) and bfloat16 compute as shipped, on the numpy weights
``repro_torch.models.convert.init_numpy`` draws from ``SEED``:

* whisper-small at its published widths, vocabulary included, with one
  encoder and one decoder (``cross``) layer: 1 x 1 500 numpy frames, 64
  tokens.  Besides the loss and the top-10 logits it records the
  gradient of the loss (``jax.value_and_grad``): its global norm and the
  norm of every ``xattn`` and ``encoder`` leaf.
* one full-width unit of llama-3.2-vision-11b, four ``attn`` layers and a
  ``cross`` layer: 1 x 256 tokens over 1 600 numpy image embeddings.

The frames and image embeddings are standard normals from
``numpy.random.default_rng(SEED + 2)``, fed in bfloat16 as the
reference's input specs give them; tokens and labels come from
``default_rng(SEED + 1)``.  Each model's entry carries a fingerprint of
its weights and of its memory input, so that a rebuild elsewhere can show
it drew the same arrays.  ``chip_smoke.py`` (phase 17) rebuilds them,
runs the port on the card (the forward through its CUDA kernels, the
gradient through the plain route) and holds the result to this file.

Run once, from the repo root (about two minutes on a CPU, one model at a
time, at most ~25 GB of memory, the vision unit's):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_port_cross_reference.py
"""
from __future__ import annotations

import dataclasses
import functools
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
TOP = 10
CASES = {
    # arch: (batch, tokens, positions of the top-10 logits, gradient)
    "whisper-small": (1, 64, (0, 21, 42, 63), True),
    "llama-3.2-vision-11b": (1, 256, (0, 85, 170, 255), False),
}
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port_cross_reference.json")


def cut_config(arch: str):
    """The architecture at full width, its decoder cut to one unit (and
    whisper's encoder to one layer)."""
    cfg = configs.get(arch)
    unit = cfg.stages[0][0]
    cut = dict(stages=((unit, 1),), n_layers=len(unit), attn_impl="xla")
    if cfg.encoder_layers:
        cut["encoder_layers"] = 1
    return dataclasses.replace(cfg, **cut)


def memory_input(cfg, batch: int) -> tuple[str, np.ndarray]:
    """The cross-attention source: (batch key, float32 standard normals of
    (batch, encoder_seq or n_img_tokens, d_model))."""
    key = "frames" if cfg.encoder_layers else "img_embeds"
    rows = cfg.encoder_seq or cfg.n_img_tokens
    rng = np.random.default_rng(SEED + 2)
    return key, rng.standard_normal((batch, rows, cfg.d_model),
                                    dtype=np.float32)


def stats(v) -> dict:
    return {"sum": float(np.sum(v, dtype=np.float64)),
            "head": [float(x) for x in np.asarray(v).reshape(-1)[:4]]}


def leaf_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def fingerprint(tree) -> dict:
    """Sums and leading values of the embeddings and of every leaf of the
    decoder's unit and of the encoder."""
    leaves = {"embed": tree["embed"], "unembed": tree["unembed"]}
    for name in ("stages", "encoder"):
        if name in tree:
            flat, _ = jax.tree_util.tree_flatten_with_path(tree[name])
            for path, v in flat:
                leaves[f"{name}.{leaf_name(path)}"] = v
    return {k: stats(v) for k, v in leaves.items()}


def grad_norms(grads) -> dict:
    """The global norm and the norm of every xattn and encoder leaf."""
    out = {"global": float(jnp.sqrt(sum(
        jnp.sum(jnp.square(g.astype(jnp.float32)))
        for g in jax.tree.leaves(grads))))}
    for name in ("stages", "encoder"):
        flat, _ = jax.tree_util.tree_flatten_with_path(grads[name])
        for path, g in flat:
            key = f"{name}.{leaf_name(path)}"
            if name == "encoder" or ".xattn." in key:
                out[key] = float(jnp.linalg.norm(
                    g.astype(jnp.float32).reshape(-1)))
    return out


def run(arch: str) -> dict:
    batch, seq, positions, with_grad = CASES[arch]
    rcfg = cut_config(arch)
    tcfg = convert.config_from_reference(rcfg)
    tree = convert.init_numpy(tcfg, SEED)
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, rcfg.vocab, (batch, seq))
    labels = rng.integers(0, rcfg.vocab, (batch, seq))
    key, mem = memory_input(rcfg, batch)
    params = jax.tree.map(jnp.asarray, tree)
    data = {"tokens": jnp.asarray(tokens, jnp.int32),
            "labels": jnp.asarray(labels, jnp.int32),
            key: jnp.asarray(mem, jnp.bfloat16)}
    hidden, *_ = jax.jit(lambda p, b: r_model.forward(
        rcfg, p, b["tokens"], **{key: b[key]}))(params, data)
    logits = np.asarray(r_model.unembed(rcfg, params, hidden), np.float32)
    if with_grad:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            functools.partial(r_model.loss_fn, rcfg), has_aux=True))(
                params, data)
    else:
        loss, _ = jax.jit(lambda p, b: r_model.loss_fn(rcfg, p, b))(
            params, data)
    top = []
    for row in range(batch):
        for pos in positions:
            ids = np.argsort(-logits[row, pos], kind="stable")[:TOP]
            top.append({"row": row, "pos": pos, "ids": ids.tolist(),
                        "logits": logits[row, pos, ids].tolist()})
    unit = rcfg.stages[0][0]
    full = configs.get(arch)
    note = (f"full width; decoder cut from {full.n_layers} layers to one "
            f"unit")
    if full.encoder_layers:
        note += f", encoder from {full.encoder_layers} layers to one"
    out = {
        "cut": {"stages": [[list(unit), 1]], "n_layers": len(unit),
                "encoder_layers": rcfg.encoder_layers,
                "param_count": rcfg.param_count(), "note": note},
        "weights": fingerprint(tree),
        "memory": {"key": key, "shape": list(mem.shape), **stats(mem)},
        "tokens": tokens.tolist(),
        "labels": labels.tolist(),
        "loss": float(loss),
        "top_logits": top,
    }
    if with_grad:
        out["grad_norms"] = grad_norms(grads)
    print(f"{arch}: loss {float(loss):.6f}, {rcfg.param_count()} "
          f"parameters" + (f", grad norm {out['grad_norms']['global']:.6f}"
                           if with_grad else ""), flush=True)
    return out


def main() -> None:
    ref = {"jax_version": jax.__version__, "attn_impl": "xla",
           "compute_dtype": "bfloat16", "seed": SEED, "models": {}}
    for arch in CASES:
        ref["models"][arch] = run(arch)
        gc.collect()
    with open(OUT, "w") as f:
        json.dump(ref, f)
        f.write("\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
