"""Write ``tests/data/torch_port_dist_reference.json`` from the JAX package.

The reference for the port's distribution layer on several ranks
(``tests/test_torch_dist_ranks.py``, 8 gloo CPU ranks): the reference's
own four multi-device cases (``tests/test_dist.py``) on 8 forced host
devices, with its meshes, shapes and model, on numpy inputs drawn from
the seeds below, which the port draws again:

* ``hier``: ``hierarchical_psum``, the flat psum, the pod psum and
  ``compressed_psum`` (with the gathered int8 codes) on a (2, 4)
  ``("pod", "data")`` mesh, each device's input the row of a (8, 3, 37)
  draw at its row-major mesh index (``distinct``) or row 0 on every
  device (``replicated``, the reference test's layout);
* ``grads``: ``make_dp_grad_fn`` on that mesh for the reference test's
  2-layer model (weights from ``repro_torch.models.convert.init_numpy``,
  8 x 16 numpy tokens), ``flat`` and ``hier``, float32 compute (so that
  the two packages differ by summation order only): loss and every
  gradient leaf, in the reference's stacked layout;
* ``attention``: ``seq_sharded_attention`` on a (2, 4) ``("data",
  "model")`` mesh at (offset, window) = (40, None), (63, 16), (0, None);
* ``placements``: for the reference test's MoE model on a (2, 2, 2)
  ``("pod", "data", "model")`` mesh, every parameter's spec and, for each
  mesh coordinate, the slice of the parameter that
  ``NamedSharding.devices_indices_map`` gives the device there.

Float arrays are stored as base64 of their little-endian float32 bytes
(int8 codes as int8 bytes), with their shapes.

Run once, from the repo root (about 1.5 minutes on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_port_dist_reference.py
"""
from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import base64  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.dist import collectives, compression, context  # noqa: E402
from repro.dist import data_parallel, decode_attn, sharding  # noqa: E402
from repro.models import ModelConfig, MoEConfig  # noqa: E402
from repro.models import loss_fn  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro_torch.models import convert  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port_dist_reference.json")
HIER_SEED, TOKEN_SEED, PARAM_SEED, ATTN_SEED = 0, 1, 2, 3
ATTN_CASES = ((40, None), (63, 16), (0, None))

# the reference test's models (tests/test_dist.py)
DENSE = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=2,
             n_kv_heads=2, d_ff=64, vocab=64, stages=((("attn",), 2),),
             head_dim=16, max_seq=32, loss_seq_chunk=16, remat=False)
MOE = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab=64, stages=((("moe",), 2),),
           head_dim=8, max_seq=32,
           moe=dict(n_experts=4, top_k=2, d_ff_expert=32))


def pack(a) -> dict:
    a = np.asarray(a)
    dt = np.int8 if a.dtype == np.int8 else np.float32
    return {"shape": list(a.shape), "dtype": np.dtype(dt).name,
            "b64": base64.b64encode(
                np.ascontiguousarray(a, dt).astype(
                    np.dtype(dt).newbyteorder("<")).tobytes()).decode()}


def path_of(path) -> list[str]:
    """A tree path as the port's keys: dict keys and list indices."""
    return [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]


def mesh(shape, axes):
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def hier_block() -> dict:
    m = mesh((2, 4), ("pod", "data"))
    x = np.random.default_rng(HIER_SEED).standard_normal(
        (8, 3, 37)).astype(np.float32)
    per_dev = P(("pod", "data"))

    def sm(f):
        return jax.shard_map(lambda v: f(v[0])[None], mesh=m,
                             in_specs=per_dev, out_specs=per_dev,
                             check_vma=False)

    out = {"x": pack(x)}
    for layout, xs in (("distinct", x), ("replicated",
                                         np.broadcast_to(x[:1], x.shape))):
        xs = jnp.asarray(np.ascontiguousarray(xs))
        out[layout] = {
            "hier": pack(sm(collectives.hierarchical_psum)(xs)),
            "flat": pack(sm(lambda v: jax.lax.psum(v, ("pod", "data")))(xs)),
            "podsum": pack(sm(lambda v: jax.lax.psum(v, "pod"))(xs)),
            "comp": pack(sm(lambda v: compression.compressed_psum(
                v, "pod"))(xs)),
            "codes": pack(sm(lambda v: jax.lax.all_gather(
                compression.quantize(v)[0], "pod"))(xs)),
        }
    return out


def grads_block() -> dict:
    m = mesh((2, 4), ("pod", "data"))
    cfg = ModelConfig(**DENSE)
    tcfg = convert.config_from_reference(cfg)
    params = jax.tree.map(jnp.asarray, convert.init_numpy(tcfg,
                                                          PARAM_SEED))
    tokens = np.random.default_rng(TOKEN_SEED).integers(
        0, cfg.vocab, (8, 16)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    lf = functools.partial(loss_fn, cfg)
    out = {}
    r_model.COMPUTE_DTYPE = jnp.float32
    try:
        for schedule in ("flat", "hier"):
            with context.use_mesh(m):
                fn = data_parallel.make_dp_grad_fn(lf, m, schedule=schedule)
                loss, grads = fn(params, batch)
            flat, _ = jax.tree_util.tree_flatten_with_path(grads)
            out[schedule] = {
                "loss": float(loss),
                "grads": [dict(path=path_of(p), **pack(g))
                          for p, g in flat]}
    finally:
        r_model.COMPUTE_DTYPE = jnp.bfloat16
    return out


def attention_block() -> dict:
    m = mesh((2, 4), ("data", "model"))
    rng = np.random.default_rng(ATTN_SEED)
    q = rng.standard_normal((2, 6, 1, 32)).astype(np.float32)
    k = rng.standard_normal((2, 3, 64, 32)).astype(np.float32)
    v = rng.standard_normal((2, 3, 64, 32)).astype(np.float32)
    out = {}
    for off, win in ATTN_CASES:
        with context.use_mesh(m):
            o = decode_attn.seq_sharded_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                window=win, q_offset=off)
        out[f"{off}_{win}"] = pack(o)
    return out


def placements_block() -> dict:
    m = mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = ModelConfig(**dict(MOE, moe=MoEConfig(**MOE["moe"])))
    specs = sharding.param_specs(cfg, m)
    ab = r_model.abstract_params(cfg)
    leaves = []
    for (path, spec), (_, leaf) in zip(
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda s: isinstance(s, P))[0],
            jax.tree_util.tree_flatten_with_path(ab)[0]):
        idx = NamedSharding(m, spec).devices_indices_map(tuple(leaf.shape))
        slices = {}
        for coord in np.ndindex(m.devices.shape):
            sl = idx[m.devices[coord]]
            slices[",".join(map(str, coord))] = [
                [s.start or 0, dim if s.stop is None else s.stop]
                for s, dim in zip(sl, leaf.shape)]
        leaves.append({
            "path": path_of(path),
            "shape": list(leaf.shape),
            "spec": [list(e) if isinstance(e, tuple) else e for e in spec],
            "slices": slices})
    return {"leaves": leaves}


def main() -> None:
    assert jax.device_count() == 8, jax.devices()
    rec = {"seeds": {"hier": HIER_SEED, "tokens": TOKEN_SEED,
                     "params": PARAM_SEED, "attention": ATTN_SEED},
           "jax": jax.__version__,
           "dense": {k: v for k, v in DENSE.items() if k != "stages"},
           "hier": hier_block(), "grads": grads_block(),
           "attention": attention_block(),
           "placements": placements_block()}
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=0)
        f.write("\n")
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
