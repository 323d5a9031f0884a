"""The Mamba-2 SSD chunked scan: the CUDA kernel's wrapper beside its
plain version.

``ssd_scan`` has the reference's signature and precondition
(``src/repro/kernels/ssd_scan.py``: x ``(B, H, S, P)``, dt ``(B, H, S)``,
a ``(H,)`` negative, b/c ``(B, G, S, N)``, ``S`` divisible by the chunk;
y ``(B, H, S, P)`` in x.dtype).  On CUDA tensors it launches the
hand-written kernel ``csrc/ssd_scan.cu`` (the port of the Pallas
``_ssd_kernel``; the source says what bounds it and what its design does
about that) on the current stream, or raises: a missing compiler, a
refused launch or an input it does not take never falls back.  dt and a
are read as float32, as the reference's kernel reads them.  On CPU tensors
it runs ``plain``, the ported ``ssd_chunked_ref``.  ``launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory a block may opt in to on an H100 (227 KB).
SHARED_LIMIT_BYTES = 232448

# Launches of the CUDA kernel since the last ``reset_launches()``.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _configure(lib: ctypes.CDLL) -> None:
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_launch.argtypes = ([ctypes.c_void_p] * 6
                                    + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.ssd_scan_shared_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_shared_bytes.argtypes = [ctypes.c_int] * 3


LIBRARY = build.Library("ssd_scan", _configure)


def load_library() -> ctypes.CDLL:
    return LIBRARY.load()


def plain(x, dt, a, b, c, *, chunk: int = 128):
    """The kernel's function in plain PyTorch (float32 arithmetic)."""
    chunk = min(chunk, x.shape[2])
    return _ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk).to(x.dtype)


def _check(x, dt, a, b, c, chunk: int) -> None:
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"x must be (B, H, S, P) and b, c (B, G, S, N), got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, h, s, _ = x.shape
    if (tuple(dt.shape) != (bsz, h, s) or tuple(a.shape) != (h,)
            or b.shape[0] != bsz or b.shape[2] != s or h % b.shape[1]):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} do not fit x {tuple(x.shape)}")
    if s % min(chunk, s):
        raise ValueError(f"seq {s} must tile by chunk {chunk}")
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """x: (B, H, S, P); dt: (B, H, S); a: (H,); b, c: (B, G, S, N) with
    H % G == 0.  Returns y: (B, H, S, P) in x.dtype."""
    global launches
    _check(x, dt, a, b, c, chunk)
    if x.device.type == "cpu":
        return plain(x, dt, a, b, c, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan takes CPU or CUDA tensors, got "
                         f"{x.device}")
    bsz, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    chunk = min(chunk, s)
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"the kernel takes x, b and c in one of float32 or "
                         f"bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    if not (x.is_contiguous() and b.is_contiguous() and c.is_contiguous()):
        raise ValueError("the kernel takes contiguous x, b and c")
    lib = load_library()
    shared = lib.ssd_scan_shared_bytes(chunk, n, p)
    if shared > SHARED_LIMIT_BYTES:
        raise ValueError(f"chunk {chunk}, N {n}, P {p} need {shared} bytes "
                         f"of shared memory, over the card's "
                         f"{SHARED_LIMIT_BYTES}")
    dt32 = dt.to(torch.float32).contiguous()
    a32 = a.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt32.data_ptr(), a32.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), bsz, h, g, s, chunk, n, p,
        _DTYPES[x.dtype], stream)
    LIBRARY.check(err)
    launches += 1
    return y
