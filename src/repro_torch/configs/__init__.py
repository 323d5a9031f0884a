"""Experiment configurations of the port.

Only the paper's own NoC experiment is ported so far; the model
architectures of ``repro.configs`` belong to the ML half (ROADMAP Queue 1
item 9).
"""
from __future__ import annotations


def noc_config():
    from repro_torch.configs.ringmesh_noc import CONFIG
    return CONFIG
