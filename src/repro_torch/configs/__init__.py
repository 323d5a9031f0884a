"""Experiment configurations of the port: the paper's own NoC experiment
and the model architectures.

``get(name)`` resolves an architecture id of the reference's registry.
The decoder-only architectures (dense, MoE, SSM and the Zamba-2 hybrid)
are ported; whisper-small and llama-3.2-vision-11b raise, naming the
part of the model zoo they wait for.
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
    "whisper-small": None,
    "llama-3.2-vision-11b": None,
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-1.3b": "mamba2_1_3b",
}

# Why the architectures that are not ported yet wait.
UNPORTED_ARCHS = (
    "it needs cross-attention and encoders (whisper-small's audio encoder, "
    "llama-3.2-vision-11b's cross-attended image memory), which are not in "
    "the port yet: their cache-free forward attends over 1 500 encoder "
    "frames or 1 600 image tokens, which do not tile by the attention "
    "kernel's 128-row kv blocks in either package")


def get(name: str):
    """Return the ModelConfig for an architecture id."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(ARCHS)}")
    if ARCHS[name] is None:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: {UNPORTED_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG


def noc_config():
    from repro_torch.configs.ringmesh_noc import CONFIG
    return CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)
