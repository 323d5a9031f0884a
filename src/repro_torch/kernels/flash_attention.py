"""Flash attention: the CUDA kernel's wrapper beside its plain version.

``flash_attention`` has the reference's signature
(``src/repro/kernels/flash_attention.py``: q ``(B, Hq, Sq, D)``, k/v
``(B, Hkv, Skv, D)``, queries at the kv tail) but not its tiling
precondition: ``Sq`` and ``Skv`` may be any length, since the kernel
launches ``ceil(Sq / 128)`` query tiles, zero-fills its loads past the
end of the sequence, masks every key at ``kp >= Skv`` and stores only
rows ``< Sq``.  So whisper's 1 500 encoder frames and 448 tokens and the
vision model's 1 600 image tokens run through it, held against
``attention_ref``, the function the reference runs at those lengths
(its ``"xla"`` route).  On CUDA tensors it launches the hand-written
kernel ``csrc/flash_attention.cu`` (the port of the Pallas
``_flash_kernel``; the source says what bounds it and what its design
does about that) on the current stream, or raises: a missing compiler, a
refused launch or an input it does not take never falls back.  The
kernel has two instantiations chosen by dtype: bfloat16 (the model's
path) multiplies on the tensor cores (``mma.sync``, 128 query rows per
block, a cp.async K/V ring), float32 keeps the scalar-FMA kernel so that
it agrees with ``plain`` to 2e-5.  On CPU
tensors it runs ``plain``, the ported ``attention_ref`` (or
``attention_chunked`` above 1 024 queries, as the reference's model routes
it).  The kernel has no backward: on CUDA tensors that require grad it
raises, and gradients take the plain route (``attn_impl="torch"``).
``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel since the last ``reset_launches()``.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _configure(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                      ctypes.c_int,
                                                      ctypes.c_void_p])


LIBRARY = build.Library("flash_attention", _configure)


def load_library() -> ctypes.CDLL:
    return LIBRARY.load()


def plain(q, k, v, *, causal: bool = True, window: int | None = None,
          scale: float | None = None):
    """The kernel's function in plain PyTorch (float32 arithmetic)."""
    fn = _ref.attention_chunked if q.shape[2] > 1024 else _ref.attention_ref
    return fn(q, k, v, causal=causal, window=window, scale=scale)


def no_backward(name: str, *tensors) -> None:
    """Raise if a CUDA input requires grad: the kernel's output is filled
    through ctypes, so autograd cannot see it and a gradient through it
    would be silently wrong."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward and its inputs "
            "require grad; take gradients through the plain route "
            "(attn_impl='torch', or the kernel's plain version)")


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         " (batch and head width equal, Hq % Hkv == 0)")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"q, k and v must share device and dtype, "
                             f"{name} is {t.dtype} on {t.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    block_q: int = 128, block_k: int = 128):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in
    q.dtype.  ``block_q`` / ``block_k`` are the reference's tiling
    arguments, accepted and unused: the kernel tiles by its own sizes and
    masks the ragged tails."""
    global launches
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got "
                         f"{q.device}")
    no_backward("flash_attention", q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes float32 or bfloat16 with head "
                         f"width in {HEAD_DIMS}, got {q.dtype}, d={d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k and v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel copies 16-byte chunks: q, k and v "
                         "must start at 16-byte aligned addresses")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lib = load_library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        sq, skv, d, 1 if causal else 0, window if window else 0,
        float(scale), _DTYPES[q.dtype], stream)
    LIBRARY.check(err)
    launches += 1
    return out
