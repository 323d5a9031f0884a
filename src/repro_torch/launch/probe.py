"""Per-stage cost probes (the port of ``repro.launch.probe``).

The reference needs them: ``cost_analysis`` counts a ``lax.scan`` body
once whatever its trip count, so the reference lowers a one-repeat probe
of each stage (and of the loss and the encoder) and adds
``probe x (reps - 1)`` to the main module's counts.  The port's repeats
are a Python list, not a scan: its dry run executes every layer of every
microbatch, so the census of the main run already counts them all, and
``corrected_costs`` returns the main counts as ``corrected`` unchanged.

The probes stay, as the per-stage breakdown under the reference's keys
(``stage<i>``, ``loss_embed``, ``encoder``, and ``loss_chunk``: one
vocab chunk of the loss): each runs one repetition of its part on the
same mesh, under the cell's conditions (forward and backward with remat
for a training cell, a fresh cache for prefill, the cache for decode)
and its own census.  They add
up: sum over stages of probe x reps x accum, plus loss_embed x accum,
plus encoder x encoder_layers x accum, is the main run's FLOPs
(``probe_total``; the census counts FLOPs of products only, which no
code outside these parts has).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import context, sharding
from repro_torch.launch import shapes as shp
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def _run(fn, mesh) -> dict:
    """``fn()`` under a census, the mesh ambient; its costs."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import census as census_mod
    with context.use_mesh(mesh), implicit_replication(), \
            census_mod.Census() as c:
        fn()
    s = c.summary()
    return {"flops": s["flops"], "bytes_accessed": s["bytes_accessed"],
            "collective_bytes": s["collectives"]["total_bytes"]}


def _params(metas, mesh, device, serve: bool, grad: bool):
    """DTensor parameters of a ParamMeta tree on their sharding rules'
    placements (bf16 for serving), leaves requiring grad if ``grad``."""
    def one(m):
        t = torch.empty(m.shape, dtype=(torch.bfloat16 if serve and
                                        m.dtype == torch.float32
                                        else m.dtype), device="meta")
        ns = sharding.NamedSharding(mesh, sharding.spec_for_axes(
            m.axes, mesh, shape=m.shape))
        p = steps._placed(t, ns, device, steps._empty)
        return p.requires_grad_(True) if grad else p
    return L.tree_map(one, metas)


def _activation(shape, spec, mesh, device, grad: bool):
    t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    ns = sharding.NamedSharding(mesh, sharding.fit_spec(spec, shape, mesh))
    x = steps._placed(t, ns, device, steps._empty)
    return x.requires_grad_(True) if grad else x


def _grad_of(out, leaves, seed=None):
    """The gradient of ``out`` at ``leaves``; ``seed`` (a tensor like
    ``out``) is the incoming gradient, laid out as ``out`` is, as the
    gradient from the rest of the model arrives in the main run."""
    leaves = [t for t in leaves if t is not None and t.requires_grad]
    torch.autograd.grad(out, leaves, grad_outputs=seed)


def stage_probe(cfg: ModelConfig, cell: shp.Cell, mesh, stage_idx: int, *,
                device: str = "cuda") -> dict:
    """Cost of ONE repetition of stage ``stage_idx`` under this cell."""
    unit, _reps = cfg.stages[stage_idx]
    train, decode = cell.kind == "train", cell.kind == "decode"
    b, s = cell.global_batch, 1 if decode else cell.seq_len
    serve = not train
    p_unit = _params({str(i): M._block_meta(cfg, k)
                      for i, k in enumerate(unit)}, mesh, device, serve,
                     train)
    x = _activation((b, s, cfg.d_model), L.act_spec(cfg, mesh), mesh,
                    device, train)
    memory = None
    if "cross" in unit and not decode:
        mem_len = cfg.encoder_seq or cfg.n_img_tokens
        b_spec = sharding.P(sharding.batch_axes(mesh))
        memory = _activation((b, mem_len, cfg.d_model), b_spec, mesh,
                             device, train and bool(cfg.encoder_layers))
    shared = None
    if "hybrid" in unit:
        shared = _params({"attn": L.attn_meta(cfg), "mlp": L.mlp_meta(cfg)},
                         mesh, device, serve, train)
    cache = None
    if serve:
        cache_sh = steps._named(mesh, sharding.cache_specs(
            cfg, mesh, b, cell.seq_len,
            seq_shard=cfg.attn_impl == "seq_shard"))[stage_idx][:1]
        cache = L.tree_map(
            lambda t, ns: steps._placed(t, ns, device, steps._zeros),
            M.stage_cache(cfg, unit, 1, b, cell.seq_len, device="meta"),
            cache_sh)

    def fwd():
        pos = cell.seq_len - 1 if decode else (0 if serve else None)
        positions = (torch.zeros(1, dtype=torch.long, device=device) + pos
                     if decode else torch.arange(s, device=device))
        sh = M.params_for_compute(cfg, shared) if shared is not None \
            else None
        return M._run_stage(cfg, unit, [p_unit], x, positions=positions,
                            memory=memory, shared=sh, cache=cache, pos=pos)

    def run():
        if train:
            y, aux, _ = fwd()
            leaves = [x, memory] + L.tree_leaves(p_unit) \
                + (L.tree_leaves(shared) if shared else [])
            if aux.requires_grad:
                _grad_of([y, aux], leaves,
                         [torch.ones_like(y), torch.ones_like(aux)])
            else:
                _grad_of(y, leaves, torch.ones_like(y))
        else:
            with torch.no_grad():
                fwd()
    return _run(run, mesh)


def _head_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, stages=(), n_layers=0, encoder_layers=0,
                               n_img_tokens=0)


def loss_embed_probe(cfg: ModelConfig, cell: shp.Cell, mesh, *,
                     device: str = "cuda") -> dict:
    """The model outside its stages, once per microbatch: the embedding,
    the final norm and the vocab-chunked loss (forward and backward) for
    a training cell, or the unembedding of the last position for
    serving."""
    hcfg = _head_cfg(cfg)
    train = cell.kind == "train"
    params = _params(M.model_meta(hcfg), mesh, device, not train, train)
    batch = {k: v for k, v in steps.placed_batch(
        hcfg, cell, mesh, device).items() if k in ("tokens", "labels")}

    def run():
        if train:
            loss, _ = M.loss_fn(hcfg, params, batch)
            _grad_of(loss, L.tree_leaves(params))
        elif cell.kind == "prefill":
            M.prefill(hcfg, params, batch["tokens"], cell.seq_len)
        else:
            M.decode_step(hcfg, params, [], batch["tokens"],
                          cell.seq_len - 1)
    return _run(run, mesh)


def loss_chunk_probe(cfg: ModelConfig, cell: shp.Cell, mesh, *,
                     device: str = "cuda") -> dict:
    """Forward and backward of one vocab chunk of the loss (the unembed
    product and its statistics, on each rank's slice of the chunk where
    the vocabulary splits over ``model``) for one microbatch."""
    b, s, d = cell.global_batch, cell.seq_len, cfg.d_model
    vc = M._vocab_chunk(cfg)
    meta = {"unembed": L.ParamMeta((d, vc), ("embed", "vocab"))}
    p = _params(meta, mesh, device, False, True)
    h = _activation((b, s, d), L.act_spec(cfg, mesh), mesh, device, True)
    labels = steps.placed_batch(cfg, cell, mesh, device)["labels"]

    def run():
        nll = M._nll(cfg, h, M.gathered(p["unembed"]), labels)
        _grad_of(nll, [h, p["unembed"]], torch.ones_like(nll))
    return _run(run, mesh)


def encoder_probe(cfg: ModelConfig, cell: shp.Cell, mesh, train: bool, *,
                  device: str = "cuda") -> dict:
    """One encoder layer (bidirectional attention + MLP) at
    ``encoder_seq``, with the encoder's positions and final norm."""
    ecfg = dataclasses.replace(cfg, encoder_layers=1)
    meta = M.model_meta(ecfg)["encoder"]
    enc = _params(meta, mesh, device, not train, train)
    b_spec = sharding.P(sharding.batch_axes(mesh))
    frames = _activation((cell.global_batch, cfg.encoder_seq, cfg.d_model),
                         b_spec, mesh, device, False)

    def run():
        if train:
            y = M._encode(ecfg, {"encoder": enc}, frames)
            _grad_of(y, L.tree_leaves(enc), torch.ones_like(y))
        else:
            with torch.no_grad():
                M._encode(ecfg, {"encoder": enc}, frames)
    return _run(run, mesh)


def probe_total(cfg: ModelConfig, probes: dict, accum: int = 1,
                key: str = "flops") -> float:
    """The probes' sum over the whole step: each stage's x reps x accum,
    loss_embed x accum, encoder x encoder_layers x accum."""
    total = sum(probes[f"stage{i}"][key] * reps * accum
                for i, (_unit, reps) in enumerate(cfg.stages))
    total += probes["loss_embed"][key] * accum
    if "encoder" in probes:
        total += probes["encoder"][key] * cfg.encoder_layers * accum
    return total


def corrected_costs(cfg: ModelConfig, cell: shp.Cell, mesh, main: dict,
                    accum: int = 1, *, device: str = "cuda") -> dict:
    """main: {'flops','bytes_accessed','collective_bytes'} of the main
    run, which counted every layer (see the module docstring): returned
    as ``corrected`` unchanged, with the per-part probes (one microbatch
    of ``global_batch / accum`` rows each)."""
    micro = cell if accum == 1 else dataclasses.replace(
        cell, global_batch=cell.global_batch // accum)
    probes = {f"stage{si}": stage_probe(cfg, micro, mesh, si, device=device)
              for si in range(len(cfg.stages))}
    probes["loss_embed"] = loss_embed_probe(cfg, micro, mesh, device=device)
    if cell.kind == "train":
        probes["loss_chunk"] = loss_chunk_probe(cfg, micro, mesh,
                                                device=device)
    if cfg.encoder_layers and cell.kind != "decode":
        probes["encoder"] = encoder_probe(cfg, micro, mesh,
                                          cell.kind == "train",
                                          device=device)
    return {"corrected": dict(main), "probes": probes}
