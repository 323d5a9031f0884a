"""Step functions (the port of ``repro.launch.steps``): the training
step (``make_train_step``, ``accum_for``) and the serving steps
(``make_prefill_step``, ``make_decode_step``).

The rest of the reference's module (``make_case``, which assembles a
step with its shardings and abstract arguments for the dry run) waits
for the port's dry-run slice.

Training takes the plain routes: neither kernel has a backward (nor has
the reference's Pallas kernels, and its training step runs with
``attn_impl="xla"``).  So a step is built only for a config whose
``attn_impl`` is ``"torch"``; given ``"cuda"`` it raises rather than
switch on the caller's behalf.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.dist.data_parallel import value_and_grad
from repro_torch.models import config as mcfg
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_update


def _value_and_grad(cfg: mcfg.ModelConfig, params, batch):
    """((loss, metrics), grads) of ``loss_fn`` at ``params``, the grads in
    each parameter's dtype, the values detached."""
    (loss, metrics), grads = value_and_grad(
        functools.partial(M.loss_fn, cfg))(params, batch)
    return (loss, {k: v.detach() for k, v in metrics.items()}), grads


def make_train_step(cfg: mcfg.ModelConfig, ocfg: AdamWConfig,
                    accum_steps: int = 1):
    """Train step with gradient accumulation: the global batch is split
    into ``accum_steps`` microbatches whose gradients add up in a float32
    accumulator — activation memory scales with the microbatch while the
    optimizer still sees the full global batch.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, batch a dict of tensors on the parameters' device."""
    if cfg.attn_impl != "torch":
        raise ValueError(
            f"{cfg.name}: training runs the plain routes (the CUDA kernels "
            f"have no backward), so it takes attn_impl='torch', got "
            f"{cfg.attn_impl!r}")

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            (loss, metrics), grads = _value_and_grad(cfg, params, batch)
        else:
            micro = [{k: t.reshape((accum_steps, t.shape[0] // accum_steps)
                                   + tuple(t.shape[1:]))[i]
                      for k, t in batch.items()}
                     for i in range(accum_steps)]
            grads = L.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
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
        params, opt_state, om = adamw_update(ocfg, params, grads, opt_state)
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
    def serve_step(params, caches, token, pos):
        return M.decode_step(cfg, params, caches, token, pos)
    return serve_step
