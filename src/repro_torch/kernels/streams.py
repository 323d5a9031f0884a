"""The simulator's random streams for a batch of points, in one CUDA launch.

``draw`` writes what ``core.sim.draw_streams`` returns — injections
[B, cycles, P] bool, destinations [B, cycles, P] int16 and, when the points
carry fault entries, the fault draws [B, cycles, F] float32 — with one
launch of the hand-written kernel ``csrc/streams.cu``.  Its bits are those
of the plain version, ``core.sim._draw_streams_plain`` over ``core.prng``
(the reference's ``jax.random`` draws); the plain version is the CPU's path
and this kernel's oracle on the card.

The host's part is ``point_table``: one int32 row a point, its ``HEADER``
words (seed, injection rate, the two float32 locality thresholds and the
permutation flag) then its permutation, uploaded in one copy; the kernel
derives ``randint``'s multipliers from the spans it folds by.  ``launch``
takes CUDA tensors only and checks them; a missing compiler, a refused
launch or a fault raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import packet as pk
from repro_torch.core import prng
from repro_torch.kernels import build

# The telemetry counter of each path's draws, one a batch.
FUSED, PLAIN = "fused", "plain"
LAUNCH_COUNTERS = {FUSED: "streams.launches[fused]",
                   PLAIN: "streams.launches[plain]"}

# A point's row of the table: these words, then its [P] permutation.
SEED, INJ_RATE, LOC_RING, LOC_BOTH, USE_PERM = range(5)
HEADER = 5


def launches() -> dict[str, int]:
    """Batches drawn by each path since the last ``telemetry.drain()``."""
    return {path: telemetry.counter(name)
            for path, name in LAUNCH_COUNTERS.items()}


def _f32_bits(x) -> int:
    return int(np.float32(x).view(np.int32))


def point_table(points, n_pes: int) -> np.ndarray:
    """The kernel's [B, HEADER + P] int32 table of ``points`` (the
    ``core.sim.SweepPoint`` s of one batch).  The locality sum is taken in
    float32, as the plain version adds its two thresholds."""
    table = np.empty((len(points), HEADER + n_pes), np.int32)
    for row, pt in zip(table, points):
        loc_ring = np.float32(pt.loc_ring)
        row[:HEADER] = [
            int(np.uint32(int(pt.seed) & prng.MASK32).view(np.int32)),
            _f32_bits(pt.inj_rate), _f32_bits(loc_ring),
            _f32_bits(loc_ring + np.float32(pt.loc_block)),
            int(bool(pt.use_perm))]
        row[HEADER:] = pt.perm_dst
    return table


def _configure(lib: ctypes.CDLL) -> None:
    lib.streams_launch.restype = ctypes.c_int
    lib.streams_launch.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])


LIBRARY = build.Library("streams", _configure,
                        error_fn="streams_error_string")


def load_library() -> ctypes.CDLL:
    """Compile ``csrc/streams.cu`` (once per source version) into
    ``build/torch_kernels/`` and load it."""
    return LIBRARY.load()


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be a {dtype} tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(table: torch.Tensor, inj_s: torch.Tensor, dst_s: torch.Tensor,
           fault_u: torch.Tensor | None = None) -> None:
    """Fill ``inj_s`` [B, cycles, P] bool, ``dst_s`` [B, cycles, P] int16
    and ``fault_u`` [B, cycles, F] float32 (None when F = 0) from the
    point ``table`` [B, HEADER + P] int32, with one launch on the current
    stream, unsynchronised.  All on one CUDA device."""
    if inj_s.dim() != 3:
        raise ValueError(f"inj_s must be [B, cycles, P], got "
                         f"{tuple(inj_s.shape)}")
    batch, cycles, p_pes = inj_s.shape
    _check("inj_s", inj_s, torch.bool, (batch, cycles, p_pes))
    _check("dst_s", dst_s, torch.int16, (batch, cycles, p_pes))
    _check("table", table, torch.int32, (batch, HEADER + p_pes))
    n_faults = 0
    if fault_u is not None:
        n_faults = fault_u.shape[-1]
        _check("fault_u", fault_u, torch.float32, (batch, cycles, n_faults))
    dev = inj_s.device
    tensors = (table, inj_s, dst_s) + (() if fault_u is None else (fault_u,))
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"the streams kernel takes CUDA tensors on one device, got "
            f"{sorted({str(t.device) for t in tensors})}; "
            f"core.sim._draw_streams_plain draws on any device")
    lib = load_library()
    err = lib.streams_launch(
        table.data_ptr(), inj_s.data_ptr(), dst_s.data_ptr(),
        0 if fault_u is None else fault_u.data_ptr(), batch, cycles, p_pes,
        n_faults, pk.PES_PER_RINGLET, pk.PES_PER_BLOCK,
        torch.cuda.current_stream(dev).cuda_stream)
    LIBRARY.check(err)
    telemetry.count(LAUNCH_COUNTERS[FUSED])


def draw(points, n_pes: int, cycles: int, device):
    """``core.sim.draw_streams`` on a CUDA ``device``: the streams of
    ``points`` (one fault count F for all) with one launch."""
    dev = torch.device(device)
    batch, n_faults = len(points), points[0].fault_links.shape[0]
    table = torch.from_numpy(point_table(points, n_pes)).to(dev)
    inj_s = torch.empty((batch, cycles, n_pes), dtype=torch.bool, device=dev)
    dst_s = torch.empty((batch, cycles, n_pes), dtype=torch.int16,
                        device=dev)
    fault_u = (torch.empty((batch, cycles, n_faults), dtype=torch.float32,
                           device=dev) if n_faults else None)
    launch(table, inj_s, dst_s, fault_u)
    return inj_s, dst_s, fault_u
