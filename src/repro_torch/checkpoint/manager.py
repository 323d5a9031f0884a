"""Checkpointing: atomic, optionally async (the port of
``repro.checkpoint.manager``, on the same on-disk layout).

Layout:  <dir>/step_<N>/arrays.npz + manifest.json
         <dir>/LATEST            (atomic pointer, written last)

* **Atomicity**: a checkpoint is written to a tmp dir and ``os.rename``d
  into place; LATEST is only updated afterwards, so a crash mid-save can
  never corrupt the restore path.
* **Async**: ``save(..., blocking=False)`` snapshots to host memory
  synchronously and writes in a background thread.
* **The reference's keys**: every leaf is stored under the reference's
  path string (dict keys and list indices joined by ``/``), and a stage's
  repeats, which the port keeps as a list of unit dicts, are stacked on a
  leading axis as the reference stacks them.  So a checkpoint written by
  either package restores in the other.  bfloat16 leaves are stored as
  their ``uint16`` bits with the true dtype in the manifest, as the
  reference stores them (there through ``ml_dtypes``, here through
  ``Tensor.view(torch.int16)``).

``restore`` puts each leaf on ``device`` (by default the device of the
target's leaf), or, given ``shardings``, onto a live mesh's placements
(elastic resharding): each leaf a DTensor of which each rank holds its
local shard.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves, tree_map


def _paths(tree, prefix: tuple = ()):
    """(key, leaf, (repeat, repeats) or None) for every leaf, in
    ``tree_map``'s order; a list of dicts is a stage's repeats, stacked
    under one key."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)) and tree \
            and isinstance(tree[0], dict):
        for r, unit in enumerate(tree):
            for key, leaf, _ in _paths(unit, prefix):
                yield key, leaf, (r, len(tree))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree, None


def _host_layout(leaf) -> tuple[tuple, np.dtype, str]:
    """(shape, numpy dtype stored, true dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return tuple(leaf.shape), np.dtype(np.uint16), "bfloat16"
        dt = torch.empty(0, dtype=leaf.dtype).numpy().dtype
        return tuple(leaf.shape), dt, str(dt)
    arr = np.asarray(leaf)
    return arr.shape, arr.dtype, str(arr.dtype)


def _copy_to_host(dst: np.ndarray, leaf) -> None:
    """Copy a leaf into its slot of a host array (bfloat16 as its bits),
    straight from the device: no intermediate host copy."""
    if isinstance(leaf, torch.Tensor):
        src = leaf.detach()
        if src.dtype == torch.bfloat16:
            src, dst = src.view(torch.int16), dst.view(np.int16)
        torch.from_numpy(dst).copy_(src)
    else:
        dst[...] = np.asarray(leaf)


def _flatten(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Every leaf as the host array stored under its key, a stage's
    repeats copied into one array stacked on a leading axis."""
    groups: dict = {}
    for key, leaf, rep in _paths(tree):
        groups.setdefault(key, (rep is not None, []))[1].append(leaf)
    flat, dtypes = {}, {}
    for key, (stacked, leaves) in groups.items():
        shape, np_dtype, dtypes[key] = _host_layout(leaves[0])
        if stacked:
            shape = (len(leaves),) + shape
        flat[key] = np.empty(shape, np_dtype)
        for r, leaf in enumerate(leaves):
            _copy_to_host(flat[key][r, ...] if stacked else flat[key], leaf)
    return flat, dtypes


def _from_host(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    # -- save --------------------------------------------------------------
    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = True) -> None:
        """Snapshot ``tree`` (+ json-able ``extra``) at ``step``."""
        self.wait()
        host, dtypes = _flatten(tree)    # synchronous device->host snapshot
        extra = dict(extra or {})

        def _write():
            tmp = self._step_dir(step) + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "extra": extra,
                           "dtypes": dtypes,
                           "keys": sorted(host.keys())}, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.dir, "LATEST.tmp"),
                       os.path.join(self.dir, "LATEST"))
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def restore(self, target: Any, step: Optional[int] = None,
                shardings: Any = None, device=None) -> tuple[Any, dict]:
        """Restore into the structure of ``target`` (a tree of tensors;
        only their shapes, dtypes and devices are read, so ``meta``
        tensors do).  Each leaf lands on ``device``, or on its target
        leaf's device if None; or, with ``shardings`` (a matching tree of
        ``dist.sharding.NamedSharding``s on the current live mesh), it is
        distributed onto its placements (elastic resharding).  Returns
        (tree, extra)."""
        if shardings is not None:
            from repro_torch.dist import sharding as shd
            shard_leaves = iter(tree_leaves(shardings))
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        leaves, stacked = [], {}
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for key, leaf, rep in _paths(target):
                if rep is None:
                    arr = data[key]
                else:
                    if key not in stacked:
                        stacked[key] = data[key]
                        if stacked[key].shape[0] != rep[1]:
                            raise ValueError(
                                f"repeats mismatch for {key}: ckpt "
                                f"{stacked[key].shape[0]} vs target "
                                f"{rep[1]}")
                    arr = stacked[key][rep[0]]
                    if rep[0] == rep[1] - 1:
                        del stacked[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"shape mismatch for {key}: ckpt {arr.shape} vs "
                        f"target {tuple(leaf.shape)}")
                host = _from_host(arr, dtypes.get(key))
                if shardings is not None:
                    leaves.append(shd.place(host.to(leaf.dtype),
                                            next(shard_leaves)))
                else:
                    leaves.append(host.to(
                        device=leaf.device if device is None else device,
                        dtype=leaf.dtype))
        it = iter(leaves)
        return tree_map(lambda _: next(it), target), manifest["extra"]
