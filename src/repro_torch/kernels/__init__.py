"""Hand-written CUDA kernels of the port, each beside its plain version.

    noc_step.py        — the NoC simulator's cycle loop: ``cycle_step`` /
                         ``run_plain`` (plain torch) and ``run_fused``
                         (the CUDA kernel in ``csrc/noc_step.cu``)
    flash_attention.py — forward attention (causal / GQA / window):
                         ``plain`` and the CUDA kernel in
                         ``csrc/flash_attention.cu``
    ssd_scan.py        — the Mamba-2 SSD chunked scan: ``plain`` and the
                         CUDA kernel in ``csrc/ssd_scan.cu``
    streams.py         — the simulator's random streams for a batch of
                         points in one launch of ``csrc/streams.cu``
                         (plain version: ``core.sim._draw_streams_plain``)
    ref.py             — the model zoo's plain oracles
    ops.py             — the model's ``"torch" | "cuda"`` switch
    build.py           — nvcc at first use, ctypes loading
"""
from repro_torch.kernels import noc_step

__all__ = ["noc_step"]
