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
    masks the ragged tails.  On CUDA tensors it calls the custom op
    ``torch.ops.repro_torch.flash_attention`` (fake tensors take its fake
    implementation, so a dry run traces through it)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got "
                         f"{q.device}")
    no_backward("flash_attention", q, k, v)
    d = q.shape[3]
    if q.dtype not in _DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes float32 or bfloat16 with head "
                         f"width in {HEAD_DIMS}, got {q.dtype}, d={d}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return torch.ops.repro_torch.flash_attention(
        q, k, v, causal, window if window else 0, float(scale))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, scale: float) -> torch.Tensor:
    """The CUDA implementation: one launch of ``csrc/flash_attention.cu``
    on the current stream (``window`` 0: none)."""
    global launches
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k and v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel copies 16-byte chunks: q, k and v "
                         "must start at 16-byte aligned addresses")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    lib = load_library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        sq, skv, d, 1 if causal else 0, window, float(scale),
        _DTYPES[q.dtype], stream)
    LIBRARY.check(err)
    launches += 1
    return out


@_flash_op.register_fake
def _(q, k, v, causal, window, scale):
    return torch.empty_like(q)


def visible_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave, queries at the kv tail: query
    i at position p = skv - sq + i sees keys lo..hi, hi = min(p, skv - 1)
    (causal) or skv - 1, lo = max(p - window + 1, 0) (window) or 0."""
    total = 0
    for i in range(sq):
        p = skv - sq + i
        hi = min(p, skv - 1) if causal else skv - 1
        lo = max(p - window + 1, 0) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def flops(q_shape, k_shape, causal: bool, window) -> int:
    """The kernel's work: two products of 2*D operations per visible
    (query, key) pair and query head (``chip_smoke.py``'s bound counts
    the same)."""
    b, hq, sq, d = q_shape
    return 4 * b * hq * d * visible_pairs(sq, k_shape[2], causal, window)


def _register_counts() -> None:
    """The op's FLOP formula (``torch.utils.flop_counter``: without it
    the kernel's work would vanish from every count) and its DTensor
    sharding rule: batch split, heads split (query and K/V heads alike,
    where both divide the mesh), or everything replicated."""
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _(q_shape, k_shape, v_shape, causal, window, scale, *a, **kw):
        return flops(q_shape, k_shape, causal, window)

    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _(q, k, v, causal, window, scale):
        rest = [None, None, None]
        out = [([Shard(0)], [Shard(0)] * 3 + rest),
               ([Replicate()], [Replicate()] * 3 + rest)]
        # the heads split as the query's are, or over the whole mesh; an
        # uneven split would pair query heads with the wrong K/V heads
        split = [q.mesh.size(d) for d, pl in enumerate(q.placements)
                 if pl == Shard(1)]
        n = math.prod(split) if split else q.mesh.size()
        if q.shape[1] % n == 0 and k.shape[1] % n == 0:
            out.append(([Shard(1)], [Shard(1)] * 3 + rest))
        return out


_register_counts()
