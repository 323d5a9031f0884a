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
            # the ranks as plain ints, read with no tensor op (a dry run
            # asks for peers inside a FakeTensorMode)
            self._grid = self._ranks().tolist()
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
        ranks = self._grid
        for a in self.axis_names:
            ranks = ranks[coord[a]]
        return int(ranks)

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


def make_fake_mesh(multi_pod: bool, rank: int = 0, *,
                   device: str = "cuda", shape=None, axes=None) -> Mesh:
    """A live production mesh in one process, for the dry run: brings up
    PyTorch's simulated world (the ``"fake"`` process-group backend, whose
    collectives return at once and move nothing) of world size 256 or
    512 as ``rank``, and returns ``make_dev_mesh`` over it.  ``shape`` /
    ``axes`` give another mesh (tests: (2, 2, 2)).  No card is needed:
    the ``DeviceMesh`` names ``device`` and holds no memory.

    Rank 0 stands for every rank: ``fit_spec`` shards only evenly divisible
    dimensions, so every rank's local shapes, and so its counts, are rank
    0's.  The process group is process-global state: end it with
    ``destroy_fake_mesh`` (in a ``finally``) before any other group."""
    import torch.distributed as dist
    # PyTorch's own simulated-world backend (its ``"fake"`` process group,
    # kept under ``torch.testing._internal``); the one import of it here.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if shape is None:
        prod = make_production_mesh(multi_pod=multi_pod)
        shape = tuple(prod.shape[a] for a in prod.axis_names)
        axes = prod.axis_names
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; destroy it "
                           "before make_fake_mesh")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))
    return Mesh(shape, axes, dm)


def destroy_fake_mesh() -> None:
    """End the process group ``make_fake_mesh`` brought up (a no-op when
    none is up), and DTensor's caches of sharding decisions and
    redistribution plans: they are keyed by mesh, and the mesh of another
    rank compares equal to this one but holds other groups."""
    import torch.distributed as dist
    from torch.distributed.tensor import _redistribute, debug
    if dist.is_initialized():
        dist.destroy_process_group()
    _redistribute.clear_redistribute_planner_cache()
    debug._clear_sharding_prop_cache()


def describe(mesh: Mesh) -> dict:
    return {"axis_names": list(mesh.axis_names),
            "shape": [int(mesh.shape[a]) for a in mesh.axis_names],
            "devices": int(mesh.size)}

