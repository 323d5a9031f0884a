"""Manual data parallelism with pluggable gradient-reduction schedules (the
port of ``repro.dist.data_parallel``).

``make_dp_grad_fn`` wraps a ``loss_fn(params, batch) -> (loss, aux)``
into a per-rank function over the mesh's batch axes: the global batch
splits across ("pod", "data") (each rank takes its rows by its mesh
coordinate, as ``sharding.batch_entry`` says), each rank takes its local
value and gradient with ``torch.autograd.grad``, and gradients are
combined by one of:

    flat      - one all-reduce over ("pod", "data")
    hier      - reduce-scatter in-pod, all-reduce across pods, all-gather
                back (``collectives.hierarchical_psum``)
    hier+int8 - the pod hop additionally int8-compressed
                (``compression.compressed_psum``)

All schedules return the same (loss, grads) up to float reassociation
(int8 adds bounded quantization error on the pod hop only), replicated
on every rank as the reference's ``out_specs=P()`` gives them.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.dist import collectives, compression, context, sharding
from repro_torch.models.layers import tree_leaves, tree_map

SCHEDULES = ("flat", "hier")


def value_and_grad(loss_fn: Callable) -> Callable:
    """``fn(params, batch) -> ((loss, aux), grads)`` of a ``loss_fn`` that
    returns ``(loss, aux)``: the gradient of every leaf by
    ``torch.autograd.grad``, in each leaf's dtype, the loss detached."""
    def fn(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, aux = loss_fn(live, batch)
        it = iter(torch.autograd.grad(loss, tree_leaves(live)))
        return (loss.detach(), aux), tree_map(lambda _: next(it), params)
    return fn


def make_dp_grad_fn(loss_fn: Callable, mesh, *, schedule: str = "flat",
                    compress: bool = False) -> Callable:
    """Return ``fn(params, batch) -> (loss, grads)`` (see module docstring).

    ``loss_fn`` must return ``(loss, aux)``; the mean loss and mean
    gradients over the global batch are returned.  On a mesh without
    batch axes this degenerates to a plain value-and-grad: the
    single-device fallback.
    """
    assert schedule in SCHEDULES, schedule
    assert not compress or schedule == "hier", \
        "compress rides the hierarchical schedule (int8 on the pod hop)"
    dp_axes = context.data_axes(mesh)
    grad_fn = value_and_grad(loss_fn)

    if not dp_axes:
        def fallback(params, batch):
            (loss, _aux), grads = grad_fn(params, batch)
            return loss, grads
        return fallback

    n_total = math.prod(int(mesh.shape[a]) for a in dp_axes)
    outer, inner = dp_axes[0], dp_axes[1:]

    def reduce_grads(g):
        if compress:
            # exact psum on the fast inner axes, int8 on the pod hop; a
            # stage's repeats stacked, as the reference keeps them, so the
            # pod hop sends one scale per reference leaf
            s = collectives.stack_repeats(g)
            if inner:
                s = tree_map(lambda t: collectives.psum(
                    t, mesh.group(inner)), s)
            s = tree_map(lambda t: compression.compressed_psum(
                t, mesh.group(outer)), s)
            g = tree_map(lambda t, r: r.to(t.dtype), g,
                         collectives.unstack_repeats(s, g))
        elif schedule == "hier" and inner:
            g = collectives.hierarchical_psum_tree(g, dp_axes, mesh=mesh)
        else:
            g = tree_map(lambda t: collectives.psum(
                t, mesh.group(dp_axes)), g)
        return tree_map(lambda t: t / n_total, g)

    def fn(params, batch):
        b = tree_leaves(batch)[0].shape[0]
        entry = sharding.batch_entry(mesh, b)
        local = tree_map(lambda t: sharding.local_rows(mesh, t, entry),
                         batch)
        # the body is a manual region: hide the ambient mesh so the model
        # code inside runs on this rank's tensors alone
        with context.suspend_mesh():
            (loss, _aux), grads = grad_fn(params, local)
        loss = collectives.psum(loss, mesh.group(dp_axes)) / n_total
        return loss, reduce_grads(grads)

    return fn
