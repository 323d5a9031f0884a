"""Experiment configurations of the port: the paper's own NoC experiment
and the model architectures.

``get(name)`` resolves an architecture id of the reference's registry;
all ten are ported.
"""
from __future__ import annotations

import importlib

ARCHS = {
    "qwen2-7b": "qwen2_7b",
    "qwen2.5-14b": "qwen2_5_14b",
    "command-r-plus-104b": "command_r_plus_104b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "whisper-small": "whisper_small",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-1.3b": "mamba2_1_3b",
}


def get(name: str):
    """Return the ModelConfig for an architecture id."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG


def noc_config():
    from repro_torch.configs.ringmesh_noc import CONFIG
    return CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)
