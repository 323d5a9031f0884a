"""Hand-written CUDA kernels of the port, each beside its plain twin.

    noc_step.py        — the NoC simulator's cycle loop: ``cycle_step`` /
                         ``run_plain`` (plain torch) and ``run_fused``
                         (the CUDA kernel in ``csrc/noc_step.cu``)
"""
from repro_torch.kernels import noc_step

__all__ = ["noc_step"]
