"""Plain PyTorch oracles of the model zoo's kernels (the ``ref.py`` layer).

Ports of ``attention_ref``, ``attention_chunked``, ``ssd_ref`` and
``ssd_chunked_ref`` of the reference's ``kernels/ref.py``, written for
clarity, in float32 arithmetic.  They are the plain versions the CUDA
kernels are held against, and the ``attn_impl="torch"`` route of the
model.

State layouts differ on purpose, as in the reference: ``ssd_ref`` carries
its state as ``(B, H, P, N)``; ``ssd_chunked_ref``, the CUDA kernel and the
decode cache use ``(B, H, N, P)``.  ``attention_ref`` masks with ``-inf``
and leaves a fully masked row NaN; ``attention_chunked`` zeroes it.
"""
from __future__ import annotations

import math

import torch


def _mask(q_pos, k_pos, causal: bool, window):
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


# ---------------------------------------------------------------------------
# Attention (GQA + causal + sliding window)
# ---------------------------------------------------------------------------
def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None, q_offset=None):
    """Reference multi-head attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0.
    window: query t attends to keys in (t - W, t].
    q_offset: absolute position of q[0] in the kv sequence (decode against
        a fixed-size cache buffer; the causal mask then also hides the
        unwritten tail).  Default: the queries sit at the kv tail.
    Returns (B, Hq, Sq, D) in q.dtype; softmax in float32.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert hq % hkv == 0
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    off = q_offset if q_offset is not None else skv - sq
    q_pos = torch.arange(sq, device=q.device) + off
    k_pos = torch.arange(skv, device=q.device)
    mask = _mask(q_pos, k_pos, causal, window)
    s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return out.to(q.dtype)


def attention_chunked(q, k, v, *, causal: bool = True,
                      window: int | None = None, scale: float | None = None,
                      q_offset=None, chunk_q: int = 512):
    """Attention over query chunks of ``chunk_q``: never holds the whole
    (Sq x Skv) score tensor.  With a sliding window only the in-window kv
    span is sliced per chunk.  Fully masked rows come out zero."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert hq % hkv == 0
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q_offset is None:
        q_offset = skv - sq
    chunk_q = min(chunk_q, sq)
    nq = -(-sq // chunk_q)
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    use_window_slice = window is not None and window + chunk_q < skv
    span = min(window + chunk_q, skv) if window is not None else skv
    outs = []
    for i in range(nq):
        qs = q[:, :, i * chunk_q:(i + 1) * chunk_q]
        rows = qs.shape[2]
        # pad rows (past Sq) keep their positions, as the reference's
        # zero-padded chunk does; they are sliced off below
        q_pos = q_offset + i * chunk_q + torch.arange(chunk_q,
                                                      device=q.device)
        if use_window_slice:
            start = min(max(q_offset + i * chunk_q - window + 1, 0),
                        skv - span)
            ks, vs = kk[:, :, start:start + span], vv[:, :, start:start + span]
            k_pos = start + torch.arange(span, device=q.device)
        else:
            ks, vs = kk, vv
            k_pos = torch.arange(skv, device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), ks.float()) * scale
        mask = _mask(q_pos[:rows], k_pos, causal, window)
        s = s.masked_fill(~mask[None, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        p = p.masked_fill(~mask[None, None], 0.0)   # fully masked rows
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vs.float()))
    return torch.cat(outs, dim=2).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space dual)
# ---------------------------------------------------------------------------
def ssd_ref(x, dt, a, b, c):
    """Reference SSD via the exact per-step recurrence.

    x: (B, H, S, P); dt: (B, H, S) post-softplus steps; a: (H,) negative
    decays; b, c: (B, G, S, N) with H % G == 0.  Returns y (B, H, S, P)
    float32.  The state is carried as (B, H, P, N):

        state_t = exp(dt_t * a) * state_{t-1} + dt_t * x_t (x) b_t
        y_t     = c_t . state_t
    """
    bsz, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    assert h % g == 0
    rep = h // g
    bb = b.repeat_interleave(rep, dim=1).float()
    cc = c.repeat_interleave(rep, dim=1).float()
    xf, dtf = x.float(), dt.float()
    da = torch.exp(dtf * a.float()[None, :, None])            # (B,H,S)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dbx = torch.einsum("bh,bhp,bhn->bhpn", dtf[:, :, t], xf[:, :, t],
                           bb[:, :, t])
        state = da[:, :, t, None, None] * state + dbx
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cc[:, :, t]))
    return torch.stack(ys, dim=2)


def ssd_chunked_ref(x, dt, a, b, c, chunk: int = 16):
    """Chunked SSD: the algorithm of the CUDA kernel (intra-chunk
    quadratic term + inter-chunk state passing), state (B, H, N, P).
    Returns y (B, H, S, P) float32; S must tile by ``chunk``.  Every
    chunk's own terms are computed at once (batched over the chunks);
    only the state passing runs chunk by chunk."""
    bsz, h, s, p = x.shape
    g, n = b.shape[1], b.shape[3]
    rep = h // g
    assert s % chunk == 0
    nc = s // chunk

    def chunks(t):   # (B, H, S, ...) -> (B, H, nc, L, ...)
        return t.reshape((bsz, h, nc, chunk) + tuple(t.shape[3:]))
    bc = chunks(b.repeat_interleave(rep, dim=1).float())
    ccx = chunks(c.repeat_interleave(rep, dim=1).float())
    xc, dc = chunks(x.float()), chunks(dt.float())
    cum = torch.cumsum(chunks(dt.float() * a.float()[None, :, None]),
                       dim=-1)                                 # log-decay
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    # intra-chunk: M[t,u] = (c_t.b_u) exp(cum_t - cum_u) dt_u, u <= t.
    # exp overflows above the diagonal: mask the exponent to -inf there,
    # so that neither the value nor its gradient meets inf (a select
    # after the exp keeps the value but not the gradient: 0 * inf is nan).
    m = ccx @ bc.transpose(-1, -2)
    decay = torch.exp(torch.where(
        tri, cum[..., :, None] - cum[..., None, :], float("-inf")))
    y = (m * decay * dc[..., None, :]) @ xc
    # each chunk's own state update, with w_u = exp(cum_L - cum_u) dt_u
    w = torch.exp(cum[..., -1:] - cum) * dc
    d_state = (bc * w[..., None]).transpose(-1, -2) @ xc       # (B,H,nc,N,P)
    carry = torch.exp(cum[..., -1])                           # (B,H,nc)
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    incoming = []
    for i in range(nc):
        incoming.append(state)
        state = carry[:, :, i, None, None] * state + d_state[:, :, i]
    # inter-chunk: the incoming state's contribution
    y = y + torch.exp(cum)[..., None] * (ccx @ torch.stack(incoming, 2))
    return y.reshape(bsz, h, s, p)
