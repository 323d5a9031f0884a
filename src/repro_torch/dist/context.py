"""Ambient mesh registry (the port of ``repro.dist.context``).

The model code never takes a mesh argument: the layers that use one ask
``context.current_mesh()`` (today only ``decode_attn`` under
``attn_impl="seq_shard"``), so the exact same forward runs on one device
(tests, smoke training) and under a live mesh.

    with context.use_mesh(mesh):
        logits, caches = decode_step(cfg, params, caches, token, pos)

``use_mesh(None)`` (or :func:`suspend_mesh`) pushes an explicit "no mesh"
frame, as the manual data-parallel path does around each rank's local
gradient.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from repro_torch.launch.mesh import Mesh

_MESH_STACK: list = []


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Register ``mesh`` as the ambient mesh for the with-block.

    Nesting is allowed; the innermost frame wins.  ``mesh=None`` actively
    hides any outer mesh (single-device fallback inside the block).
    """
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


@contextlib.contextmanager
def suspend_mesh():
    """Hide the ambient mesh for the with-block (see module docstring)."""
    with use_mesh(None) as m:
        yield m


def current_mesh() -> Optional[Mesh]:
    """The innermost ambient mesh, or None when none is active."""
    return _MESH_STACK[-1] if _MESH_STACK else None


# Mesh axes that carry the (global) batch dimension, outermost first.  The
# production meshes use ("data", "model") and ("pod", "data", "model");
# anything that is not a batch axis is a tensor/sequence axis.
BATCH_AXES = ("pod", "data")


def data_axes(mesh: Optional[Mesh] = None) -> tuple[str, ...]:
    """Batch-carrying axes present in ``mesh`` (outermost first).

    With no mesh (and none ambient) returns ``()``: callers treat that as
    the single-device fallback.
    """
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)
