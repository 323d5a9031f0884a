"""Experiment configurations of the port: the paper's own NoC experiment
and the model architectures.

``get(name)`` resolves an architecture id of the reference's registry.
Only ``zamba2-1.2b`` is ported so far; the other ids raise, naming the
part of the model zoo they wait for.
"""
from __future__ import annotations

import importlib

ARCHS = {
    "qwen2-7b": None,
    "qwen2.5-14b": None,
    "command-r-plus-104b": None,
    "h2o-danube-1.8b": None,
    "llama4-scout-17b-a16e": None,
    "phi3.5-moe-42b-a6.6b": None,
    "whisper-small": None,
    "llama-3.2-vision-11b": None,
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-1.3b": None,
}


def get(name: str):
    """Return the ModelConfig for an architecture id."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")
    if ARCHS[name] is None:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: it needs the rest of the "
            "model zoo (the dense attn kind, MoE, cross-attention, "
            "encoders and the other configurations)")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG


def noc_config():
    from repro_torch.configs.ringmesh_noc import CONFIG
    return CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)
