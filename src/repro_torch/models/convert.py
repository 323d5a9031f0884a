"""Carry parameters and configurations between the JAX reference and the
port.

The reference keeps a stage's repeats on a leading axis of every leaf
(``stages[i][str(j)]`` dicts of ``(reps, ...)`` arrays); the port keeps a
list with one unit dict per repeat.  ``from_reference`` turns the
reference's parameter tree, given as numpy arrays, into the port's
tensors; ``to_reference`` is its inverse.  Both walk the trees as they
find them, so every layer kind's subtree (attention with its QKV biases,
cross-attention, the MLP, the experts with a shared expert, Mamba)
crosses alike, and so do the encoder's own stacked stages
(``encoder/stages``, the same leading repeats axis).
``config_from_reference`` /
``config_to_reference`` carry a ``ModelConfig`` across as its fields,
mapping ``attn_impl`` between the reference's ``"xla"`` / ``"pallas"`` and
the port's ``"torch"`` / ``"cuda"`` (``"seq_shard"`` keeps its name).  No
module here imports the reference: a test hands the numpy arrays and
the fields across.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig
from repro_torch.models.layers import tree_map
from repro_torch.models.model import model_meta

_IMPL_FROM_REFERENCE = {"xla": "torch", "pallas": "cuda",
                        "seq_shard": "seq_shard"}
_IMPL_TO_REFERENCE = {v: k for k, v in _IMPL_FROM_REFERENCE.items()}


def _unstack(tree, r: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, r) for k, v in tree.items()}
    return tree[r]


def _stack(units: list):
    u0 = units[0]
    if isinstance(u0, dict):
        return {k: _stack([u[k] for u in units]) for k in u0}
    return np.stack(units)


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _stage_reps(cfg: ModelConfig) -> dict:
    """Repeats of each stage, by the key of the subtree that holds the
    stages: the model's and the encoder's."""
    reps = {None: [r for _, r in cfg.stages]}
    if cfg.encoder_layers:
        reps["encoder"] = [cfg.encoder_layers]
    return reps


def from_reference(cfg: ModelConfig, tree, device="cuda"):
    """The reference's parameter tree (numpy leaves, repeats stacked) ->
    the port's parameters on ``device`` (the card unless the caller asks
    for the CPU, as the tests do)."""
    reps = _stage_reps(cfg)

    def walk(node, key=None):
        out = {k: walk(v, k) if k == "encoder" else _to_torch(v, device)
               for k, v in node.items() if k != "stages"}
        out["stages"] = [[_to_torch(_unstack(stage, r), device)
                          for r in range(n)]
                         for n, stage in zip(reps[key], node["stages"])]
        return out
    return walk(tree)


def to_reference(cfg: ModelConfig, params) -> dict:
    """The port's parameters -> the reference's tree of numpy arrays."""
    def walk(node):
        out = {k: walk(v) if k == "encoder" else _to_numpy(v)
               for k, v in node.items() if k != "stages"}
        out["stages"] = [_stack([_to_numpy(u) for u in stage])
                         for stage in node["stages"]]
        return out
    return walk(params)


def config_from_reference(ref_cfg) -> ModelConfig:
    """A reference ``ModelConfig`` (any dataclass with its fields) -> the
    port's, with ``attn_impl`` mapped."""
    f = {fl.name: getattr(ref_cfg, fl.name)
         for fl in dataclasses.fields(ref_cfg)}
    if f["ssm"] is not None:
        f["ssm"] = SSMConfig(**dataclasses.asdict(f["ssm"]))
    if f["moe"] is not None:
        f["moe"] = MoEConfig(**dataclasses.asdict(f["moe"]))
    f["attn_impl"] = _IMPL_FROM_REFERENCE[f["attn_impl"]]
    return ModelConfig(**f)


def config_to_reference(cfg: ModelConfig) -> dict:
    """The port's ``ModelConfig`` -> keyword arguments of the reference's,
    with ``attn_impl`` mapped (nested configs as dicts of their fields)."""
    f = {fl.name: getattr(cfg, fl.name) for fl in dataclasses.fields(cfg)}
    for k in ("ssm", "moe"):
        if f[k] is not None:
            f[k] = dataclasses.asdict(f[k])
    f["attn_impl"] = _IMPL_TO_REFERENCE[f["attn_impl"]]
    return f


def init_numpy(cfg: ModelConfig, seed: int) -> dict:
    """Parameters drawn with numpy from ``seed``, in the reference's layout
    (repeats stacked), with the reference's init distributions: the same
    arrays for both packages, on any machine."""
    rng = np.random.default_rng(seed)

    def draw(m, lead=()):
        shape = lead + m.shape
        if m.init == "normal":
            return rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(m.scale)
        if m.init == "zeros":
            return np.zeros(shape, np.float32)
        if m.init == "ones":
            return np.ones(shape, np.float32)
        if m.init == "a_log":  # A = -exp(a_log); a_log ~ log U[1, 16]
            return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
        if m.init == "dt_bias":  # softplus^-1 of U[dt_min, dt_max]
            u = rng.uniform(1e-3, 0.1, shape)
            return (u + np.log(-np.expm1(-u))).astype(np.float32)
        raise ValueError(m.init)

    def walk(node):
        # the leaves outside the stages first, then each stage's repeats
        # stacked on a leading axis; the encoder's stages alike
        out = {k: walk(v) if k == "encoder" else tree_map(draw, v)
               for k, v in node.items() if k != "stages"}
        out["stages"] = [tree_map(lambda m, n=len(st): draw(m, (n,)), st[0])
                         for st in node["stages"]]
        return out
    return walk(model_meta(cfg))
