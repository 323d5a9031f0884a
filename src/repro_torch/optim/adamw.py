"""AdamW with global-norm clipping and a cosine schedule, as pure
functions over the port's parameter tree (the port of
``repro.optim.adamw``).

The moments mirror the parameter tree and stay float32 whatever the
parameter dtype.  The update is the reference's, operation for operation
in float32, not ``torch.optim``'s: the parity tests compare it leaf by
leaf.  Weight decay goes to matrices only, by the reference's rule
``ndim >= 2`` on its own layout, where a stage's repeats are stacked on a
leading axis: so a stage's norm scales and biases (``(repeats, d)`` there)
decay, and the top-level ones do not.  The port keeps a stage's repeats
as a list of unit dicts, so a leaf inside such a list counts that axis.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warm-up to ``cfg.lr``, then a cosine down to
    ``min_lr_ratio * lr`` at ``total_steps``; a float32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _map(f, *trees, stacked: bool = False):
    """``tree_map`` that also hands ``f`` whether the leaf sits in a
    stage's repeats (first argument); the trees are matched by key."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(f, *(t[k] for t in trees), stacked=stacked)
                for k in t0}
    if isinstance(t0, (list, tuple)):
        inner = stacked or (len(t0) > 0 and isinstance(t0[0], dict))
        return [_map(f, *(t[i] for t in trees), stacked=inner)
                for i in range(len(t0))]
    return f(stacked, *trees)


def _pick(tree, i: int):
    """The i-th entry of every (new param, m, v) leaf of ``_map``'s
    result."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, *,
                 donate: bool = False):
    """One AdamW step.  Returns (new_params, new_state, metrics) with
    metrics ``{"grad_norm", "lr"}``.  By default the inputs are left as
    they were.  ``donate=True``: the step owns ``params`` and ``state``
    (the reference's training case donates them) and writes the update
    into their tensors, leaf by leaf, which come back; the arithmetic is
    the same operations in the same order, so the result is bit-equal to
    the functional form's."""
    step = state["step"].add_(1) if donate else state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cosine_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(stacked, p, g, m, v):
        if donate:
            g = _like(g, m)
        g = g.to(torch.float32) * scale
        if donate:
            m = m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v = v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        else:
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        # decay only matrices (norms/scalars exempt), counted on the
        # reference's layout
        if p.dim() + stacked >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        if donate and p.dtype == torch.float32:
            return p.sub_(lr * delta), m, v
        newp = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return (p.copy_(newp) if donate else newp), m, v

    out = _map(upd, params, grads, state["m"], state["v"])
    new_state = {"m": _pick(out, 1), "v": _pick(out, 2), "step": step}
    return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


def _like(g, m):
    """A DTensor gradient on its moment's placements (autograd may hand it
    back on others, e.g. a pending sum), so that the in-place update keeps
    the moment's layout; any other gradient as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and isinstance(m, DTensor) \
            and tuple(g.placements) != tuple(m.placements):
        return g.redistribute(m.device_mesh, m.placements)
    return g
