"""Step functions and the dry run's cases (the port of
``repro.launch.steps``): the training step (``make_train_step``,
``accum_for``), the serving steps (``make_prefill_step``,
``make_decode_step``) and ``make_case``, which assembles one dry-run
cell's step with its arguments placed on a live mesh.

``make_case`` is the reference's: the same route per cell, the same
parameter, optimizer, cache and batch placements (``sharding``), serving
on bfloat16 parameters.  Where the reference returns a jitted function
over abstract arguments for XLA to partition, the port returns the plain
step function and DTensors over the mesh (fake ones, on PyTorch's
``FakeTensorMode``, unless a ``fill`` makes real ones), whose local
shards are the reference's per-device shapes; running the step on them
is the global program, DTensor inserting the collectives
(``launch.dryrun``).  The training and decode steps own their
parameters, optimizer state and caches, as the reference's
``donate_argnums`` donates them: they write into the arguments' local
shards, so the census counts no second copy.

Training takes the plain routes: neither kernel has a backward (nor has
the reference's Pallas kernels, and its training step runs with
``attn_impl="xla"``).  So a step is built only for a config whose
``attn_impl`` is ``"torch"``; given ``"cuda"`` it raises rather than
switch on the caller's behalf.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Optional

import torch

from repro_torch.dist import sharding
from repro_torch.dist.data_parallel import value_and_grad
from repro_torch.launch import shapes as shp
from repro_torch.models import config as mcfg
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def _value_and_grad(cfg: mcfg.ModelConfig, params, batch):
    """((loss, metrics), grads) of ``loss_fn`` at ``params``, the grads in
    each parameter's dtype, the values detached."""
    (loss, metrics), grads = value_and_grad(
        functools.partial(M.loss_fn, cfg))(params, batch)
    return (loss, {k: v.detach() for k, v in metrics.items()}), grads


def _micro(t, i: int, accum: int):
    """Microbatch ``i`` of ``accum``: rows ``i * B/accum`` on of the batch;
    of a DTensor batch, that share of every rank's rows (the rows a rank
    holds stay on it, the microbatches together are the batch)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        local = t.to_local()
        part = local.reshape((accum, local.shape[0] // accum)
                             + tuple(local.shape[1:]))[i]
        return DTensor.from_local(part, t.device_mesh, t.placements,
                                  run_check=False)
    return t.reshape((accum, t.shape[0] // accum) + tuple(t.shape[1:]))[i]


def make_train_step(cfg: mcfg.ModelConfig, ocfg: AdamWConfig,
                    accum_steps: int = 1, keep_grads: bool = False):
    """Train step with gradient accumulation: the global batch is split
    into ``accum_steps`` microbatches whose gradients add up in a float32
    accumulator — activation memory scales with the microbatch while the
    optimizer still sees the full global batch.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, batch a dict of tensors on the parameters' device.  The
    step owns ``params`` and ``opt_state`` (the reference's training case
    donates both): AdamW writes into their tensors, which come back
    (``adamw_update(donate=True)``, bit-equal to the functional form).  A
    caller that keeps the old values passes a copy.  ``keep_grads``: the
    metrics also hold the step's gradients (``"grads"``, the parameters'
    tree), for checks that hold them to another step's."""
    if cfg.attn_impl != "torch":
        raise ValueError(
            f"{cfg.name}: training runs the plain routes (the CUDA kernels "
            f"have no backward), so it takes attn_impl='torch', got "
            f"{cfg.attn_impl!r}")

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            (loss, metrics), grads = _value_and_grad(cfg, params, batch)
        else:
            micro = [{k: _micro(t, i, accum_steps) for k, t in batch.items()}
                     for i in range(accum_steps)]
            grads = L.tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            loss = 0.0
            for mb in micro:
                (loss_i, _), g = _value_and_grad(cfg, params, mb)
                grads = L.tree_map(lambda a, b: a + b.to(torch.float32),
                                   grads, g)
                loss = loss + loss_i
            grads = L.tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            metrics = {"ce": loss, "aux": torch.zeros(
                (), dtype=torch.float32, device=loss.device)}
        params, opt_state, om = adamw_update(ocfg, params, grads, opt_state,
                                             donate=True)
        if keep_grads:
            om["grads"] = grads
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def accum_for(cfg: mcfg.ModelConfig, cell) -> int:
    """Gradient-accumulation factor per cell (any object with the
    reference's ``Cell.kind``): big models microbatch so the activation
    working set fits device memory; microbatch stays divisible by the
    data-axis extent of both production meshes (32)."""
    if cell.kind != "train":
        return 1
    n = cfg.param_count()
    if n > 6e10:
        return 8
    if n > 2e10:
        return 4
    if n > 8e9:
        return 2
    return 1


def make_prefill_step(cfg: mcfg.ModelConfig, max_seq: int):
    def prefill_step(params, batch):
        logits, caches, _mem = M.prefill(
            cfg, params, batch["tokens"], max_seq=max_seq,
            frames=batch.get("frames"), img_embeds=batch.get("img_embeds"))
        return logits, caches
    return prefill_step


def make_decode_step(cfg: mcfg.ModelConfig):
    """``serve_step(params, caches, token, pos) -> (logits, caches)``.
    The step owns ``caches`` (the reference's decode case donates them):
    the new rows are written into the given tensors, which come back
    (``models.decode_step(donate=True)``).  A caller that keeps the old
    cache calls ``models.decode_step`` or passes a copy."""
    def serve_step(params, caches, token, pos):
        return M.decode_step(cfg, params, caches, token, pos, donate=True)
    return serve_step


# ---------------------------------------------------------------------------
# case assembly (arguments placed on a live mesh)
# ---------------------------------------------------------------------------
def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """A rank's shard shape of a global ``shape`` under a (fitted) spec:
    each dimension divided by the sizes of its mesh axes (``fit_spec``
    keeps only axes that divide it evenly)."""
    return tuple(d // math.prod(int(mesh.shape[a])
                                for a in sharding.entry_axes(e))
                 for d, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def _placed(t, ns: sharding.NamedSharding, device, fill):
    """A DTensor of ``t``'s global shape and dtype on ``ns``, its local
    shard a new tensor on ``device`` (``fill`` makes it: ``torch.empty``
    for a fake case)."""
    from torch.distributed.tensor import DTensor
    local = fill(local_shape(tuple(t.shape), ns.spec, ns.mesh), t.dtype,
                 device)
    return DTensor.from_local(local, ns.mesh.device_mesh, ns.placements,
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())


def _batch_shardings(mesh, batch):
    bspec = sharding.batch_spec(mesh)

    def one(leaf):
        parts = [bspec[0] if len(bspec) else None]
        parts += [None] * (leaf.dim() - 1)
        return sharding.NamedSharding(mesh, sharding.fit_spec(
            sharding.P(*parts), tuple(leaf.shape), mesh))

    return {k: one(v) for k, v in batch.items()}


def placed_batch(cfg: mcfg.ModelConfig, cell: shp.Cell, mesh, device,
                 fill=None) -> dict:
    """The cell's batch (``shapes.batch_specs``) as DTensors split over
    the batch axes."""
    batch = shp.batch_specs(cfg, cell)
    shardings = _batch_shardings(mesh, batch)
    return {k: _placed(v, shardings[k], device, fill or _empty)
            for k, v in batch.items()}


def _serve_params(cfg):
    """Serving uses bf16 weights."""
    return L.tree_map(
        lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
        M.abstract_params(cfg))


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def real_fill(generator: torch.Generator):
    """A ``fill`` for a real case: floats drawn N(0, 0.02) (a parameter's
    scale, so the step's values stay finite), integers zero (valid token
    ids and cache slots)."""
    def fill(shape, dtype, device):
        if dtype.is_floating_point:
            return (torch.randn(shape, generator=generator, device=device)
                    * 0.02).to(dtype)
        return torch.zeros(shape, dtype=dtype, device=device)
    return fill


def _named(mesh, specs):
    """A spec tree as ``NamedSharding``s (walked by hand: a spec is a
    tuple, which ``tree_map`` would walk into)."""
    if isinstance(specs, dict):
        return {k: _named(mesh, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_named(mesh, v) for v in specs]
    return sharding.NamedSharding(mesh, specs)


def _relaid(tree, shardings):
    """``tree``'s DTensor leaves redistributed to ``shardings`` (the
    reference's ``out_shardings``); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    def one(x, ns):
        if not isinstance(x, DTensor):
            return x
        return sharding.constrain(x, ns.spec, ns.mesh)
    return L.tree_map(one, tree, shardings)


@dataclasses.dataclass
class Case:
    name: str
    fn: Any               # the plain step function
    args: tuple           # DTensors on the mesh (fake unless filled)
    cfg: mcfg.ModelConfig
    cell: shp.Cell
    accum: int = 1
    mode: Any = None      # the FakeTensorMode the arguments live in


def make_case(cfg: mcfg.ModelConfig, cell: shp.Cell, mesh,
              *, rules=None, hier_hint: bool = False,
              attn_override: Optional[str] = None, device: str = "cuda",
              fill=None) -> Case:
    """The step of one dry-run cell with its arguments placed on the live
    ``mesh`` (see the module docstring).  The route is the reference's:
    ``"seq_shard"`` for ``long_500k``, else its ``"xla"``, the port's
    plain ``"torch"``; ``attn_override="cuda"`` takes the kernels.
    ``hier_hint`` is accepted and unused, as in the reference.  The
    arguments are fake DTensors on ``device`` in ``Case.mode`` (a
    ``FakeTensorMode``; run the step inside it), or, given a ``fill``,
    real tensors of the same local shapes that it makes.  ``fn`` returns
    its outputs on the reference's ``out_shardings``: parameters and
    optimizer state on their placements, the caches on ``cache_specs``,
    logits and metrics replicated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    del hier_hint
    cfg = dataclasses.replace(
        cfg, max_seq=max(cfg.max_seq, cell.seq_len),
        attn_impl=attn_override or
        ("seq_shard" if cell.shape == shp.LONG_500K else "torch"))
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fill is None \
        else None
    fill = fill or _empty
    with mode if mode is not None else contextlib.nullcontext():
        return _assemble(cfg, cell, mesh, rules, device, fill, mode)


def _assemble(cfg, cell, mesh, rules, device, fill, mode) -> Case:
    def put(tree, shardings):
        return L.tree_map(lambda t, ns: _placed(t, ns, device, fill), tree,
                          shardings)

    pspecs = sharding.param_shardings(cfg, mesh, rules)
    batch = placed_batch(cfg, cell, mesh, device, fill)
    replicated = sharding.NamedSharding(mesh, sharding.P())

    if cell.kind == "train":
        params = put(M.abstract_params(cfg), pspecs)
        # the moments on the parameters' placements, zero as adamw_init's
        opt = {k: L.tree_map(lambda t, ns: _placed(t, ns, device, _zeros),
                             M.abstract_params(cfg), pspecs)
               for k in ("m", "v")}
        opt["step"] = _placed(adamw_init({"p": torch.empty(
            (), device="meta")})["step"], replicated, device, _zeros)
        opt_sh = {"m": pspecs, "v": pspecs, "step": replicated}
        accum = accum_for(cfg, cell)
        step = make_train_step(cfg, AdamWConfig(), accum_steps=accum)

        def train_fn(params, opt_state, batch):
            p, o, metrics = step(params, opt_state, batch)
            metrics = {k: _relaid(v, replicated) for k, v in metrics.items()}
            return _relaid(p, pspecs), _relaid(o, opt_sh), metrics

        return Case(cell.name, train_fn, (params, opt, batch), cfg, cell,
                    accum, mode)

    params = put(_serve_params(cfg), pspecs)
    seq_shard = cell.shape == shp.LONG_500K
    cache_sh = _named(mesh, sharding.cache_specs(
        cfg, mesh, cell.global_batch, cell.seq_len, seq_shard=seq_shard))

    if cell.kind == "prefill":
        step = make_prefill_step(cfg, max_seq=cell.seq_len)

        def prefill_fn(params, batch):
            logits, caches = step(params, batch)
            return _relaid(logits, replicated), _relaid(caches, cache_sh)

        return Case(cell.name, prefill_fn, (params, batch), cfg, cell, 1,
                    mode)

    caches = put(M.init_cache(cfg, cell.global_batch, cell.seq_len,
                              device="meta"), cache_sh)
    step = make_decode_step(cfg)

    def decode_fn(params, caches, token, pos):
        logits, new = step(params, caches, token, pos)
        return _relaid(logits, replicated), _relaid(new, cache_sh)

    # the position is the reference's int32 scalar, here a Python int:
    # the last slot of the cache, as the reference's probe decodes at
    return Case(cell.name, decode_fn,
                (params, caches, batch["tokens"], cell.seq_len - 1), cfg,
                cell, 1, mode)
