"""Hierarchical collectives (the Ring-Mesh reduction schedule in software;
the port of ``repro.dist.collectives``).

A flat ``psum`` over ("pod", "data") moves the full gradient across the
pod boundary.  The hierarchical schedule mirrors the paper's
ring-then-mesh traffic shaping:

    1. reduce-scatter inside each pod (over the fast inner axes): every
       rank ends up owning 1/N_inner of the reduction;
    2. all-reduce only that shard across pods (the expensive hop moves
       1/N_inner of the bytes);
    3. all-gather inside each pod to restore the full tensor.

The result equals the flat psum up to float reassociation.  The
reference's collectives run inside ``shard_map`` bodies over named axes;
here each rank runs them on its own tensors over the live mesh's process
groups (``Mesh.group``): ``psum`` is ``all_reduce``, a tiled
``psum_scatter`` is ``reduce_scatter`` of the input's chunks (group
position j keeps chunk j) and a tiled ``all_gather`` is ``all_gather``
into a list, concatenated in group order.  These list forms are in every
PyTorch release the port meets, on NCCL and on gloo; the single-tensor
forms changed their names (``reduce_scatter_tensor`` is deprecated in
favour of ``reduce_scatter_single`` from PyTorch 2.13).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.dist import context


def psum(x, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (a new tensor)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum_replicated(x, group) -> torch.Tensor:
    """``psum`` of a value that every rank of ``group`` then holds as one
    replicated result (the reference's global sum inside one program):
    differentiable, each rank's gradient the result's gradient as it is
    (a replicated result's gradient is whole on every rank already)."""
    return _ReplicatedSum.apply(x, group)


def psum_scatter(x, group) -> torch.Tensor:
    """Tiled reduce-scatter of a 1-D ``x`` whose length divides by the
    group's size: group position j gets chunk j of the sum."""
    n = dist.get_world_size(group)
    out = x.new_empty(x.shape[0] // n)
    dist.reduce_scatter(out, list(x.contiguous().chunk(n)),
                        op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather(x, group, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather: the ranks' ``x`` concatenated along ``dim`` in
    group order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def hierarchical_psum(x, axes: tuple[str, ...] = ("pod", "data"), *,
                      mesh=None):
    """All-reduce ``x`` over ``axes`` of ``mesh`` (the ambient one if None)
    with the hierarchical schedule.

    ``axes[0]`` is the outer (pod-boundary) axis; the remaining axes are
    the intra-pod axes used for the reduce-scatter/all-gather phases.
    With a single axis this degenerates to a plain psum.
    """
    mesh = mesh if mesh is not None else context.current_mesh()
    axes = tuple(axes)
    if len(axes) == 1:
        return psum(x, mesh.group(axes))
    outer, inner = axes[0], axes[1:]
    n_inner = math.prod(int(mesh.shape[a]) for a in inner)
    flat = x.reshape(-1)
    size = flat.shape[0]
    pad = (-size) % n_inner
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat
    for a in inner:
        shard = psum_scatter(shard, mesh.group(a))
    shard = psum(shard, mesh.group(outer))
    for a in reversed(inner):
        shard = all_gather(shard, mesh.group(a))
    return shard[:size].reshape(x.shape)


def hierarchical_psum_tree(tree, axes: tuple[str, ...] = ("pod", "data"), *,
                           mesh=None):
    """``hierarchical_psum`` over every leaf of a tree."""
    from repro_torch.models.layers import tree_map
    return tree_map(lambda t: hierarchical_psum(t, axes, mesh=mesh), tree)


def stack_repeats(tree):
    """``tree`` in the reference's layout: each stage's repeats (a list of
    unit dicts) stacked leaf by leaf on a leading axis (a copy)."""
    from repro_torch.models.layers import tree_map
    if isinstance(tree, dict):
        return {k: stack_repeats(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return tree_map(lambda *ts: torch.stack(ts), *tree)
    if isinstance(tree, list):
        return [stack_repeats(v) for v in tree]
    return tree


def unstack_repeats(stacked, like):
    """The inverse of ``stack_repeats``: ``stacked`` in the layout of
    ``like`` (each repeat a view of its stacked leaves)."""
    from repro_torch.models.layers import tree_map
    if isinstance(like, dict):
        return {k: unstack_repeats(stacked[k], v) for k, v in like.items()}
    if isinstance(like, list) and like and isinstance(like[0], dict):
        return [tree_map(lambda t, r=r: t[r], stacked)
                for r in range(len(like))]
    if isinstance(like, list):
        return [unstack_repeats(s, v) for s, v in zip(stacked, like)]
    return stacked
