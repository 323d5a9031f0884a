"""Public wrappers around the model zoo's kernels (the ``ops.py`` layer).

Every op has an ``impl`` switch, the port's form of the reference's
``"xla" | "pallas"``:

* ``"torch"`` — the plain PyTorch oracle (``kernels/ref.py``), on any
                device;
* ``"cuda"``  — the hand-written CUDA kernel's wrapper, which launches the
                kernel on CUDA tensors (or raises) and runs its plain
                version on CPU tensors.

The model calls these wrappers only.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd

IMPLS = ("torch", "cuda")


def _check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None, impl: str = "cuda",
              block_q: int = 128, block_k: int = 128):
    """GQA attention with optional causal mask and sliding window.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D)."""
    if _check_impl(impl) == "torch":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  scale=scale)
    return _fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window,
                               scale=scale, block_q=block_q, block_k=block_k)


def ssd(x, dt, a, b, c, *, chunk: int = 128, impl: str = "cuda"):
    """Mamba-2 SSD scan. x: (B, H, S, P), dt: (B, H, S), a: (H,),
    b/c: (B, G, S, N) -> (B, H, S, P), float32-accumulated, x.dtype out.

    Sequences that do not tile by ``chunk`` are zero-padded on the right
    (causal: the pad cannot affect the real prefix) and sliced back."""
    impl = _check_impl(impl)
    s = x.shape[2]
    chunk = min(chunk, s) if s % chunk and s < chunk else chunk
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        dt = F.pad(dt, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    if impl == "torch":
        out = _ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk).to(x.dtype)
    else:
        out = _ssd.ssd_scan(x.contiguous(), dt, a, b.contiguous(),
                            c.contiguous(), chunk=chunk)
    return out[:, :, :s] if pad else out
