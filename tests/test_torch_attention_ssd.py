"""The port's attention and SSD functions vs the reference's Pallas kernels.

The same numpy-made inputs go to both packages.  The reference's kernels
run in interpret mode on the CPU, as its own tests run them, and its
``ref.py`` oracles run as they are; the port runs its plain versions
(``kernels/ref.py``, and the wrappers, which take the plain route for CPU
tensors).

Tolerances.  Attention uses ``tests/test_kernels.py``'s ``tol()``: 2e-5 in
float32 (summation order only; a softmax-weighted mean has no
cancellation) and 2e-2 in bfloat16 (outputs rounded to bfloat16 on both
sides).  The SSD in float32 uses that file's 3e-4, its tolerance between
two SSD algorithms (``test_ssd_scan_matches_exact_recurrence``): the two
frameworks' float32 cumsums round differently (~2e-6 on the log-decays,
measured), exp carries that into every term, and an output element is a
sum of terms up to ~100 times its size; measured worst 2.6e-4 at
outputs of magnitude 89.  In bfloat16 the SSD uses 2e-2, and 5e-2 against
the exact recurrence, as that file does.

The CUDA kernels themselves run only on the card: the ``cuda``-marked test
skips here, and ``chip_smoke.py`` holds them against their plain versions
at the model's shapes on the H100.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as r_flash_attention
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels import ssd_scan as r_ssd_scan
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import ssd_scan as t_ssd

torch.set_num_threads(2)

# tests/test_kernels.py:26-36
ATTN_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window, bq, bk)
    (1, 2, 2, 128, 128, 64, True, None, 64, 64),     # MHA causal
    (2, 4, 2, 128, 128, 64, True, None, 64, 64),     # GQA
    (1, 8, 1, 128, 128, 32, True, None, 32, 64),     # MQA
    (1, 2, 2, 128, 128, 64, False, None, 64, 64),    # bidirectional (enc)
    (1, 4, 4, 256, 256, 64, True, 64, 64, 64),       # sliding window
    (1, 4, 2, 256, 256, 64, True, 100, 64, 64),      # SWA, window % block != 0
    (2, 4, 2, 1, 256, 64, True, None, 1, 64),        # decode: 1 query token
    (1, 4, 4, 64, 256, 64, True, None, 32, 64),      # chunked prefill tail
    (1, 2, 2, 128, 128, 128, True, None, 128, 128),  # MXU-aligned d=128
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def both(arrays, dtype_name):
    """The same numpy arrays as jax and torch arrays of one dtype."""
    jd, td = DTYPES[dtype_name]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def close(got, want, **kw):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **kw)


def attn_inputs(case, seed=0):
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_reference(case, dtype):
    _, _, _, _, _, _, causal, window, bq, bk = case
    (jq, jk, jv), (tq, tk, tv) = both(attn_inputs(case), dtype)
    kw = dict(causal=causal, window=window)
    r_kernel = r_flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                                 interpret=True, **kw)
    r_plain = r_ref.attention_ref(jq, jk, jv, **kw)
    got = t_ref.attention_ref(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype
    close(got, r_kernel, **tol(dtype))
    close(got, r_plain, **tol(dtype))
    # the kernel's wrapper takes the plain route on CPU tensors
    close(t_flash.flash_attention(tq, tk, tv, block_q=bq, block_k=bk, **kw),
          r_kernel, **tol(dtype))
    # the chunked route (small chunks: several per sequence, a padded
    # tail, window slices)
    chunked = t_ref.attention_chunked(tq, tk, tv, chunk_q=48, **kw)
    close(chunked, r_kernel, **tol(dtype))
    close(chunked, r_plain, **tol(dtype))


def test_attention_scale_override():
    case = (1, 2, 2, 64, 64, 32)
    (jq, jk, jv), (tq, tk, tv) = both(attn_inputs(case, 1), "float32")
    want = r_flash_attention(jq, jk, jv, scale=0.5, block_q=32,
                             block_k=32, interpret=True)
    close(t_ref.attention_ref(tq, tk, tv, scale=0.5), want, **tol("float32"))
    close(t_ref.attention_chunked(tq, tk, tv, scale=0.5, chunk_q=16), want,
          **tol("float32"))
    close(t_ops.attention(tq, tk, tv, scale=0.5, impl="torch"), want,
          **tol("float32"))


@pytest.mark.parametrize("window", [None, 24])
def test_attention_q_offset_into_a_cache_buffer(window):
    """Decode against a fixed-size buffer: queries at ``q_offset``, the
    causal mask hides the unwritten tail; the chunked route with a window
    slices the in-window span."""
    case = (2, 4, 2, 3, 96, 16)
    (jq, jk, jv), (tq, tk, tv) = both(attn_inputs(case, 2), "float32")
    for off in (0, 17, 93):
        kw = dict(causal=True, window=window, q_offset=off)
        want = r_ref.attention_ref(jq, jk, jv, **kw)
        close(t_ref.attention_ref(tq, tk, tv, **kw), want, **tol("float32"))
        close(t_ref.attention_chunked(tq, tk, tv, chunk_q=2, **kw),
              r_ref.attention_chunked(jq, jk, jv, chunk_q=2, **kw),
              **tol("float32"))


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
SSD_CASES = [
    # (B, H, G, S, P, N, chunk)   tests/test_kernels.py's matrix
    (1, 2, 1, 64, 32, 16, 16),
    (2, 4, 2, 128, 32, 16, 32),
    (1, 4, 1, 128, 64, 32, 64),
    (1, 8, 8, 64, 16, 16, 16),     # G == H (ungrouped)
    (1, 2, 1, 128, 32, 16, 128),   # single chunk == whole sequence
]


def ssd_tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=3e-4, rtol=3e-4)


def ssd_inputs(case, seed=0, log_a_scale=0.5, dt_shift=0.0):
    b, h, g, s, p, n, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, s, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h, s)) + dt_shift)
                  ).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * log_a_scale).astype(np.float32)
    bb = rng.standard_normal((b, g, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, g, s, n)).astype(np.float32)
    return x, dt, a, bb, cc


def ssd_both(arrays, dtype):
    """x, dt, b, c in ``dtype``; a stays float32, as the model passes it."""
    x, dt, a, bb, cc = arrays
    (jx, jdt, jb, jc), (tx, tdt, tb, tc) = both([x, dt, bb, cc], dtype)
    return ((jx, jdt, jnp.asarray(a), jb, jc),
            (tx, tdt, torch.from_numpy(a), tb, tc))


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_matches_reference(case, dtype):
    chunk = case[-1]
    rj, rt = ssd_both(ssd_inputs(case), dtype)
    r_kernel = r_ssd_scan(*rj, chunk=chunk, interpret=True)
    got = t_ref.ssd_chunked_ref(*rt, chunk=chunk)
    close(got, r_ref.ssd_chunked_ref(*rj, chunk=chunk), **ssd_tol(dtype))
    close(got.to(rt[0].dtype), r_kernel, **ssd_tol(dtype))
    close(t_ssd.ssd_scan(*rt, chunk=chunk), r_kernel, **ssd_tol(dtype))
    # the exact recurrence, both ways
    exact = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=3e-4, rtol=3e-4)
    step = t_ref.ssd_ref(*rt)
    close(step, r_ref.ssd_ref(*rj), **ssd_tol(dtype))
    close(step, r_kernel, **exact)


@pytest.mark.parametrize("regime", ["fast_decay", "slow_decay"])
def test_ssd_decay_extremes(regime):
    """Large dt * |a| (exp(cum) underflows to 0 within a chunk; above the
    diagonal exp(cum_t - cum_u) overflows and must be selected away, not
    multiplied by 0) and near-zero decay (the state barely forgets)."""
    case = (1, 4, 2, 64, 16, 16, 32)
    kw = dict(log_a_scale=2.5, dt_shift=3.0) if regime == "fast_decay" \
        else dict(log_a_scale=0.1, dt_shift=-6.0)
    arrays = ssd_inputs(case, seed=3, **kw)
    if regime == "slow_decay":
        arrays = (arrays[0], arrays[1], arrays[2] * 1e-3, *arrays[3:])
    rj, rt = ssd_both(arrays, "float32")
    want = r_ssd_scan(*rj, chunk=32, interpret=True)
    got = t_ref.ssd_chunked_ref(*rt, chunk=32)
    assert torch.isfinite(got).all()
    close(got, want, **ssd_tol("float32"))
    close(got, r_ref.ssd_ref(*rj), atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("s,chunk", [(40, 16), (8, 16), (70, 32)])
def test_ops_ssd_pads_like_the_reference(s, chunk):
    """``ops.ssd``'s right padding and its chunk rule: S not a multiple of
    the chunk (padded) and S shorter than the chunk (chunk cut to S)."""
    case = (2, 4, 1, s, 16, 16, chunk)
    rj, rt = ssd_both(ssd_inputs(case, seed=4), "float32")
    want = r_ops.ssd(*rj, chunk=chunk, impl="pallas_interpret")
    np.testing.assert_allclose(np.asarray(r_ops.ssd(*rj, chunk=chunk,
                                                    impl="xla")),
                               np.asarray(want), atol=2e-5, rtol=2e-5)
    for impl in ("torch", "cuda"):  # "cuda" on CPU tensors: the plain route
        got = t_ops.ssd(*rt, chunk=chunk, impl=impl)
        assert got.shape == rt[0].shape
        close(got, want, **ssd_tol("float32"))


# ---------------------------------------------------------------------------
# the wrappers: plain route on the CPU, no fallback elsewhere
# ---------------------------------------------------------------------------
def test_wrappers_run_plain_on_cpu_and_count_no_launch():
    t_flash.reset_launches()
    t_ssd.reset_launches()
    q = torch.randn(1, 2, 64, 16)
    k = torch.randn(1, 1, 64, 16)
    out = t_ops.attention(q, k, k, impl="cuda", block_q=32, block_k=32)
    torch.testing.assert_close(out, t_ref.attention_ref(q, k, k),
                               atol=0, rtol=0)
    x = torch.randn(1, 2, 32, 8)
    dt = torch.rand(1, 2, 32)
    a = -torch.rand(2)
    b = torch.randn(1, 1, 32, 4)
    y = t_ssd.ssd_scan(x, dt, a, b, b, chunk=16)
    torch.testing.assert_close(y, t_ref.ssd_chunked_ref(x, dt, a, b, b,
                                                        chunk=16),
                               atol=0, rtol=0)
    assert t_flash.launches == 0 and t_ssd.launches == 0


def test_wrappers_check_their_inputs():
    q = torch.randn(1, 2, 64, 16)
    k = torch.randn(1, 1, 64, 16)
    # no tiling precondition: ragged lengths run (the kernel masks them)
    torch.testing.assert_close(
        t_flash.flash_attention(q[:, :, :60], k[:, :, :61], k[:, :, :61],
                                block_q=32),
        t_ref.attention_ref(q[:, :, :60], k[:, :, :61], k[:, :, :61]),
        atol=0, rtol=0)
    with pytest.raises(ValueError, match="fit"):
        t_flash.flash_attention(q, torch.randn(1, 3, 64, 16),
                                torch.randn(1, 3, 64, 16))
    with pytest.raises(ValueError, match="window"):
        t_flash.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t_flash.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    x = torch.randn(1, 2, 32, 8)
    dt = torch.rand(1, 2, 32)
    b = torch.randn(1, 1, 32, 4)
    with pytest.raises(ValueError, match="tile"):
        t_ssd.ssd_scan(x, dt, -torch.rand(2), b, b, chunk=24)
    with pytest.raises(ValueError, match="fit"):
        t_ssd.ssd_scan(x, dt, -torch.rand(3), b, b, chunk=16)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t_ssd.ssd_scan(x.to("meta"), dt.to("meta"),
                       torch.rand(2, device="meta"), b.to("meta"),
                       b.to("meta"), chunk=16)
    with pytest.raises(ValueError, match="impl"):
        t_ops.ssd(x, dt, -torch.rand(2), b, b, impl="pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    td = DTYPES[dtype][1]
    for case in ATTN_CASES:
        _, _, _, _, _, _, causal, window, bq, bk = case
        q, k, v = (torch.from_numpy(a).to(td).cuda()
                   for a in attn_inputs(case))
        got = t_flash.flash_attention(q, k, v, causal=causal, window=window,
                                      block_q=bq, block_k=bk)
        want = t_flash.plain(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), **tol(dtype))
    for case in SSD_CASES:
        x, dt, a, bb, cc = (torch.from_numpy(t).cuda()
                            for t in ssd_inputs(case))
        x, bb, cc = x.to(td), bb.to(td), cc.to(td)
        got = t_ssd.ssd_scan(x, dt, a, bb, cc, chunk=case[-1])
        want = t_ssd.plain(x, dt, a, bb, cc, chunk=case[-1])
        torch.testing.assert_close(got.float(), want.float(),
                                   **ssd_tol(dtype))
