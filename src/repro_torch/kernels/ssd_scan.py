"""The Mamba-2 SSD chunked scan: the CUDA kernel's wrapper beside its
plain version.

``ssd_scan`` has the reference's signature and precondition
(``src/repro/kernels/ssd_scan.py``: x ``(B, H, S, P)``, dt ``(B, H, S)``,
a ``(H,)`` negative, b/c ``(B, G, S, N)``, ``S`` divisible by the chunk;
y ``(B, H, S, P)`` in x.dtype).  On CUDA tensors it launches the
hand-written kernel ``csrc/ssd_scan.cu`` (the port of the Pallas
``_ssd_kernel``; the source says what bounds it and what its design does
about that) on the current stream, or raises: a missing compiler, a
refused launch or an input it does not take never falls back.  Which
kernel runs is decided by dtype alone: bfloat16 runs on the tensor cores
(``mma.sync``, a cp.async tile ring, ``k`` blocks per (batch, head) from
``plan``), float32 keeps the scalar-FMA kernel, one block per (batch,
head) or, where its tiles do not fit one block (d_state 128 at chunk
128), the fewest ``k`` that do, so that it agrees with ``plain`` to
3e-4.  dt and a are read as
float32, as the reference's kernel reads them.  On CPU tensors it runs
``plain``, the ported ``ssd_chunked_ref``.  The kernel has no backward:
on CUDA tensors that require grad it raises, and gradients take the plain
route (``attn_impl="torch"``).  ``launches`` counts the kernel's
launches, one per call.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import no_backward

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory a block may opt in to on an H100 (227 KB), and its SMs.
SHARED_LIMIT_BYTES = 232448
SMS = 132
# Threads per block of the float32 (scalar) and bfloat16 (tensor-core)
# kernels; the padded sizes of the bfloat16 kernel's state rows (N) and
# block columns (P / k), its template instantiations.
SCALAR_THREADS, TC_THREADS = 512, 256
STATE_ROWS = (16, 32, 64, 128, 256)
TILE_WIDTHS = (16, 32, 64)

# Launches of the CUDA kernel since the last ``reset_launches()``.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def kernel_dims(n: int, p: int, dtype) -> tuple[int, int]:
    """N and P as ``dtype``'s kernel sees them: the bfloat16 kernel's rows
    are 16-byte multiples, so the wrapper pads both to multiples of 8."""
    return (n, p) if dtype == torch.float32 else (_round(n, 8), _round(p, 8))


def shared_bytes(chunk: int, n: int, p: int, k: int, dtype) -> int | None:
    """Bytes of dynamic shared memory one block of ``dtype``'s kernel
    takes at chunk length ``chunk``, ``n`` state rows and ``p`` columns
    split over ``k`` blocks per (batch, head), as the kernel's
    ``ssd_scan_shared_bytes`` counts them; None for a split the kernel
    does not take.  ``n`` and ``p`` as the kernel sees them
    (``kernel_dims``).

    float32: float32 state [N][P/k], x [L][P/k], b [L][N+1], c [L][N],
    the score tile [L][L+1], cum, dt and w [L].  bfloat16, with L, N and
    P / k padded to LP (a multiple of 16), NP (``STATE_ROWS``) and W
    (``TILE_WIDTHS``) and rows padded by 8 elements: x [2][LP][W+8], b and
    c [2][LP][NP+8] each, the state's hi and lo halves [NP][W+8] each (all
    bf16), dt [2][LP] and cum, exp(cum) and w [3][LP] (float32)."""
    if dtype == torch.float32:
        if k < 1 or p % k:
            return None
        w = p // k
        return 4 * (n * w + chunk * w + chunk * (n + 1) + chunk * n
                    + chunk * (chunk + 1) + 3 * chunk)
    pc = p // k if k > 0 and p % k == 0 else 0
    if n % 8 or n > STATE_ROWS[-1] or not pc or pc % 8 \
            or pc > TILE_WIDTHS[-1]:
        return None
    lp = _round(chunk, 16)
    np_ = next(r for r in STATE_ROWS if r >= n)
    w = next(t for t in TILE_WIDTHS if t >= pc)
    return (4 * lp * (w + 8) + 8 * lp * (np_ + 8) + 4 * np_ * (w + 8)
            + 20 * lp)


def splits(chunk: int, n: int, p: int, dtype) -> list[int]:
    """Every k (blocks per (batch, head)) whose block fits
    ``SHARED_LIMIT_BYTES`` at this shape, smallest first: for float32, the
    k that divide P; for bfloat16, the k that cut the padded P into equal
    slices of 8 to 64 columns."""
    n, p = kernel_dims(n, p, dtype)
    ks = range(1, p + 1) if dtype == torch.float32 else range(1, p // 8 + 1)
    return [k for k in ks
            if (nb := shared_bytes(chunk, n, p, k, dtype)) is not None
            and nb <= SHARED_LIMIT_BYTES]


def plan(bh: int, chunk: int, n: int, p: int, dtype, *,
         split: int | None = None) -> tuple[int, int, int]:
    """``(k, threads, shared_bytes)`` of a launch over ``bh`` (batch,
    head) pairs, ``k`` blocks per pair, each owning P / k columns of the
    state: float32 takes the smallest k that fits (1 up to d_state 64 at
    chunk 128, 2 at d_state 128), scalar blocks; bfloat16 picks k by
    measured time (``_pick``), tensor-core blocks.
    ``split`` asks for one k (it must fit).  Raises ``ValueError`` when
    nothing fits."""
    fits = splits(chunk, n, p, dtype)
    if not fits:
        raise ValueError(
            f"chunk {chunk}, N {n}, P {p} in {dtype} need more than "
            f"{SHARED_LIMIT_BYTES} bytes of shared memory per block at "
            f"every split of P")
    if split is not None:
        if split not in fits:
            raise ValueError(f"split {split} does not fit chunk {chunk}, N "
                             f"{n}, P {p} in {dtype}: {fits} do")
        k = split
    elif dtype == torch.float32:
        k = fits[0]
    else:
        k = _pick(bh, fits)
    threads = SCALAR_THREADS if dtype == torch.float32 else TC_THREADS
    return k, threads, shared_bytes(chunk, *kernel_dims(n, p, dtype), k,
                                    dtype)


def _pick(bh: int, fits: list[int]) -> int:
    """The bfloat16 kernel's k, by measured time (chip_smoke.py phase 8;
    PERF.md): the smallest fitting split whose blocks cover 90 % of the
    SMs, else the largest.  Each extra block of a (batch, head) repeats
    C B^T and M, which costs more than its warps hide once every SM has a
    block: at Zamba2 scoring (128 pairs) k = 1 beat k = 2, 4 and 8; at 8
    pairs k = 4 and 8 beat k = 1 by a quarter."""
    for k in fits:
        if bh * k >= 0.9 * SMS:
            return k
    return fits[-1]


def _configure(lib: ctypes.CDLL) -> None:
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_launch.argtypes = ([ctypes.c_void_p] * 6
                                    + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.ssd_scan_shared_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_shared_bytes.argtypes = [ctypes.c_int] * 5


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


def _aligned(t):
    """``t`` or, if its data does not start on 16 bytes, a copy."""
    return t.clone() if t.data_ptr() % 16 else t


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128, split: int | None = None):
    """x: (B, H, S, P); dt: (B, H, S); a: (H,); b, c: (B, G, S, N) with
    H % G == 0.  Returns y: (B, H, S, P) in x.dtype.  ``split`` forces the
    kernel's k (tests and timings only; ``plan`` picks it).  On CUDA
    tensors it calls the custom op ``torch.ops.repro_torch.ssd_scan``
    (fake tensors take its fake implementation)."""
    _check(x, dt, a, b, c, chunk)
    if x.device.type == "cpu":
        return plain(x, dt, a, b, c, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan takes CPU or CUDA tensors, got "
                         f"{x.device}")
    no_backward("ssd_scan", x, dt, a, b, c)
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"the kernel takes x, b and c in one of float32 or "
                         f"bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    return torch.ops.repro_torch.ssd_scan(x, dt, a, b, c,
                                          min(chunk, x.shape[2]),
                                          split if split else 0)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cuda")
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, chunk: int,
            split: int) -> torch.Tensor:
    """The CUDA implementation: one launch of ``csrc/ssd_scan.cu`` on the
    current stream (``split`` 0: ``plan``'s k)."""
    global launches
    if not (x.is_contiguous() and b.is_contiguous() and c.is_contiguous()):
        raise ValueError("the kernel takes contiguous x, b and c")
    bsz, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    k, _, shared = plan(bsz * h, chunk, n, p, x.dtype, split=split or None)
    n_k, p_k = kernel_dims(n, p, x.dtype)
    if x.dtype == torch.bfloat16:
        # Zero columns of b and c add nothing to C B^T or to the state;
        # zero columns of x give zero columns of y, cut off below.
        if p_k != p:
            x = F.pad(x, (0, p_k - p))
        if n_k != n:
            b, c = F.pad(b, (0, n_k - n)), F.pad(c, (0, n_k - n))
        x, b, c = _aligned(x), _aligned(b), _aligned(c)
    lib = load_library()
    kernel_bytes = lib.ssd_scan_shared_bytes(chunk, n_k, p_k, k,
                                             _DTYPES[x.dtype])
    if kernel_bytes != shared:
        raise RuntimeError(f"the kernel counts {kernel_bytes} bytes of "
                           f"shared memory at chunk {chunk}, N {n_k}, P "
                           f"{p_k}, k {k}; plan counts {shared}")
    dt32 = dt.to(torch.float32).contiguous()
    a32 = a.to(torch.float32).contiguous()
    y = x.new_empty((bsz, h, s, p_k))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt32.data_ptr(), a32.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), bsz, h, g, s, chunk, n_k, p_k, k,
        _DTYPES[x.dtype], stream)
    LIBRARY.check(err)
    launches += 1
    return (y[..., :p] if p_k != p else y).contiguous()


@_ssd_op.register_fake
def _(x, dt, a, b, c, chunk, split):
    return torch.empty_like(x)


def flops(x_shape, b_shape, chunk: int) -> int:
    """The kernel's work per call: per chunk and head the four products,
    C.B^T and M @ X over the lower triangle's L(L+1)/2 pairs, C @ state
    and the state update B^T @ X, 2 operations a multiply-add
    (``chip_smoke.py``'s bound counts the same)."""
    bsz, h, s, p = x_shape
    n = b_shape[3]
    tri = chunk * (chunk + 1) // 2
    return bsz * h * (s // chunk) * 2 * (tri * n + tri * p + 2 * chunk * n * p)


def _register_counts() -> None:
    """The op's FLOP formula and its DTensor sharding rule: batch split,
    heads split (with one group of B and C, whole on every rank), or
    everything replicated."""
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.ssd_scan)
    def _(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk, split, *a,
          **kw):
        return flops(x_shape, b_shape, chunk)

    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.ssd_scan.default)
    def _(x, dt, a, b, c, chunk, split):
        rest = [None, None]
        out = [([Shard(0)], [Shard(0), Shard(0), Replicate(), Shard(0),
                             Shard(0)] + rest),
               ([Replicate()], [Replicate()] * 5 + rest)]
        if b.shape[1] == 1:
            out.append(([Shard(1)], [Shard(1), Shard(1), Shard(0),
                                     Replicate(), Replicate()] + rest))
        return out


_register_counts()
