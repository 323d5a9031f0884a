"""Device meshes (the port of ``repro.launch.mesh``).

A ``Mesh`` names its axes and their sizes.  That is all the spec math of
``dist.sharding`` reads (``axis_names`` and ``shape``, a dict from axis
name to size, as the reference reads a ``jax.sharding.Mesh``), so the
production meshes are *abstract*: no process group, no device.

The *live* form runs one process per rank under ``torch.distributed``.
It also holds a ``torch.distributed.device_mesh.DeviceMesh`` (ranks laid
out row-major over the axes, the first axis outermost, as JAX lays out a
mesh) and gives the process group of any set of its axes (``group``):
one group per axis from the ``DeviceMesh``, and one per set of several
axes (the flat ``("pod", "data")`` psum), created when the mesh is built,
in the same order on every rank.  A group's ranks are in mesh order, so
position j of a reduce-scatter or a gather is the j-th shard of the
reference's tiled ``psum_scatter`` / ``all_gather``.

    make_production_mesh(multi_pod=False)   # abstract (16, 16)
    torch.distributed.init_process_group("gloo", ...)
    mesh = make_dev_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
"""
from __future__ import annotations

import itertools
import math

import torch


class Mesh:
    """Named mesh axes and their sizes; live when it holds a
    ``DeviceMesh`` (see the module docstring)."""

    def __init__(self, shape, axis_names, device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        assert len(self.shape) == len(self.axis_names) == len(tuple(shape)), \
            (shape, axis_names)
        self.device_mesh = device_mesh
        self._groups: dict = {}
        if device_mesh is not None:
            self._make_groups()

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def live(self) -> bool:
        return self.device_mesh is not None

    def _ranks(self) -> torch.Tensor:
        return self.device_mesh.mesh.reshape(
            tuple(self.shape[a] for a in self.axis_names))

    def _make_groups(self) -> None:
        """One process group per set of two or more axes (each axis alone
        is the ``DeviceMesh``'s own): for each such set, one group per
        coordinate of the other axes, every group created on every rank in
        the same order, as ``new_group`` requires."""
        import torch.distributed as dist
        ranks = self._ranks()
        me = dist.get_rank()
        names = self.axis_names
        for k in range(2, len(names) + 1):
            for axes in itertools.combinations(names, k):
                dims = [names.index(a) for a in axes]
                rest = [d for d in range(len(names)) if d not in dims]
                blocks = ranks.permute(rest + dims).reshape(
                    -1, math.prod(self.shape[a] for a in axes))
                for block in blocks.tolist():
                    group = dist.new_group(block)
                    if me in block:
                        self._groups[axes] = group

    def _ordered(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(
                    f"axis {a!r} is not in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of this rank over ``axes`` (one name or
        several; in mesh order whatever order they are given in)."""
        if not self.live:
            raise RuntimeError("an abstract mesh has no process groups; "
                               "build a live one with make_dev_mesh")
        axes = self._ordered(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]

    def coordinate(self) -> dict[str, int]:
        """This rank's index along every axis."""
        if not self.live:
            raise RuntimeError("an abstract mesh has no ranks")
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    def index(self, axes) -> int:
        """This rank's row-major position over ``axes`` (mesh order, the
        first outermost): its shard of a dimension split over them."""
        coord = self.coordinate()
        i = 0
        for a in self._ordered(axes):
            i = i * self.shape[a] + coord[a]
        return i

    def peer(self, axis: str, index: int) -> int:
        """Global rank of the process at this rank's coordinate with
        ``axis`` set to ``index``."""
        coord = self.coordinate()
        coord[axis] = index
        return int(self._ranks()[tuple(coord[a] for a in self.axis_names)])

    def __repr__(self) -> str:
        kind = "live" if self.live else "abstract"
        return f"Mesh({self.shape}, {kind})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production fleet's mesh, abstract: one pod of 16 x 16
    (``data`` x ``model``), or two pods (``pod`` x ``data`` x ``model``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_dev_mesh(shape=(2, 2), axes=("data", "model"), *,
                  device: str = "cuda") -> Mesh:
    """A live mesh over the running process group: one rank per process,
    on the card (NCCL) unless ``device="cpu"`` (gloo).  The group must be
    up (``torch.distributed.init_process_group``) and its world size must
    be the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_dev_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    shape = tuple(int(n) for n in shape)
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {dist.get_world_size()}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_dev_mesh(device='cuda') needs a CUDA device "
                           "and none is available; pass device='cpu'")
    dm = init_device_mesh(device, shape, mesh_dim_names=tuple(axes))
    return Mesh(shape, axes, dm)


def describe(mesh: Mesh) -> dict:
    return {"axis_names": list(mesh.axis_names),
            "shape": [int(mesh.shape[a]) for a in mesh.axis_names],
            "devices": int(mesh.size)}

