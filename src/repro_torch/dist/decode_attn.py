"""Sequence-sharded decode attention over a ring of the ``model`` axis (the
port of ``repro.dist.decode_attn``).

Long-context decode is KV-bound: a 512k cache does not fit one device, and
head-sharding dies when the head count does not divide the ``model`` axis
(6-head GQA on an 8-wide axis).  So the *sequence* dimension of the cache
shards over ``model`` and the (tiny) query visits every shard as the
chunks move round a ring of point-to-point sends: the software analogue
of the paper's ring transfers.  Each step moves one KV chunk to the
neighbour while every rank consumes the chunk it holds (flash-decoding /
ring-attention).

Per ring step the rank folds its current chunk into a streaming-softmax
accumulator (running max ``m``, normalizer ``l``, weighted value sum), so
the result is exact (``kernels.ref.attention_ref``'s) while no rank ever
works on more than ``S / n_shards`` keys.  The reference's ``ppermute``
with ``perm=[(j, j + 1 mod n)]`` is one ``batch_isend_irecv`` within the
``model`` group: after step s a rank holds the chunk of rank
``(i - s) mod n``.

The ring runs on local chunks (``ring_attention_local``): under a live
mesh every rank holds its own chunk of a cache stored sharded by
sequence (``sharding.cache_specs(seq_shard=True)``), on DTensors (the
caches of ``launch.steps.make_case`` and of a prefill of DTensor tokens,
whose blocks run on the local shards) and on plain tensors alike (a
prefill of plain tokens under the mesh, or a whole cache placed with
``sharding.shard_cache``, the counterpart of jit's ``in_shardings``).
Decode writes each new row on its owning rank, and both reach the ring
through ``seq_sharded_attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.dist import collectives, context, sharding
from repro_torch.kernels import ref as kref

_NEG = -1e30  # finite mask value: keeps the streaming max NaN-free


def _ring_shift(mesh, axis: str, n: int, tensors):
    """Send each tensor to the next rank of ``axis`` and receive the
    previous rank's (the reference's ``ppermute`` ring)."""
    i = mesh.coordinate()[axis]
    nxt, prv = mesh.peer(axis, (i + 1) % n), mesh.peer(axis, (i - 1) % n)
    group = mesh.group(axis)
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, recv):
        ops.append(dist.P2POp(dist.isend, t, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def _ring_attention(q, k, v, off, *, mesh, axis: str, n: int, chunk: int,
                    skv: int, causal: bool, window: Optional[int],
                    scale: float):
    """One rank's part: q (b, Hq, Sq, D) whole on every rank of ``axis``;
    k/v this rank's chunks (b, Hkv, chunk, D).  ``off`` is the absolute
    position of q[0].

    GQA stays grouped throughout: the ring moves the *raw* Hkv-head
    chunks (never the group-repeated tensors), so each step transfers
    exactly S/n keys' worth of bytes."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    dev = q.device
    kk = k.float().contiguous()
    vv = v.float().contiguous()
    qg = q.float().reshape(b, hkv, group, sq, d)
    q_pos = off + torch.arange(sq, device=dev)

    i = mesh.coordinate()[axis]
    m = torch.full((b, hkv, group, sq), _NEG, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, group, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32,
                      device=dev)

    for step in range(n):
        # after `step` rotations, we hold the chunk owned by rank i - step
        owner = (i - step) % n
        k_pos = owner * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kk) * scale
        mask = (k_pos < skv)[None, :]                    # padding tail
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        mask = mask[None, None, None]                    # (1,1,1,Sq,chunk)
        smax = torch.where(mask, s, _NEG).amax(dim=-1)
        m_new = torch.maximum(m, smax)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] \
            + torch.einsum("bhgqk,bhkd->bhgqd", p, vv)
        m = m_new
        if step < n - 1:
            kk, vv = _ring_shift(mesh, axis, n, (kk, vv))

    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def seq_mesh(seq_axis: str = "model"):
    """The ambient live mesh when its ``seq_axis`` has more than one rank
    (a cache is then stored sharded by sequence over it), else None."""
    mesh = context.current_mesh()
    if mesh is None or not mesh.live or seq_axis not in mesh.axis_names \
            or int(mesh.shape[seq_axis]) <= 1:
        return None
    return mesh


def seq_sharded_attention(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, q_offset=None,
                          scale: Optional[float] = None,
                          skv: Optional[int] = None, rows=None,
                          seq_axis: str = "model"):
    """Decode attention with the KV sequence sharded over ``seq_axis``.

    q: (B, Hq, Sq, D); k, v: (b, Hkv, chunk, D), this rank's chunk of a
    cache of ``skv`` rows (n chunks by default), Hq % Hkv == 0.  Matches
    ``kernels.ref.attention_ref`` semantics (causal / sliding window /
    ``q_offset`` into a fixed cache buffer).  ``rows``: the batch entry
    (``sharding.batch_entry``) of the rows the chunk holds when q holds
    every row: q's rows are narrowed to them, and the result's rows are
    gathered back, so every rank returns the whole (B, Hq, Sq, D); with
    None q holds the chunk's rows and the result is this rank's.

    Without an ambient mesh, or when the mesh lacks ``seq_axis`` or it has
    size 1 (the chunk is then the whole cache), this falls back to the
    single-device reference path, so callers never need to special-case
    the unsharded world.
    """
    mesh = seq_mesh(seq_axis)
    if mesh is None:
        return kref.attention_ref(q, k, v, causal=causal, window=window,
                                  scale=scale, q_offset=q_offset)
    n = int(mesh.shape[seq_axis])
    assert q.shape[1] % k.shape[1] == 0, (q.shape, k.shape)
    out = ring_attention_local(
        sharding.local_rows(mesh, q, rows), k, v,
        skv=k.shape[2] * n if skv is None else skv, causal=causal,
        window=window, q_offset=q_offset, scale=scale, seq_axis=seq_axis)
    axes = sharding.entry_axes(rows)
    return collectives.all_gather(out, mesh.group(axes)) if axes else out


def ring_attention_local(q, k, v, *, skv: int, causal: bool = True,
                         window: Optional[int] = None, q_offset=None,
                         scale: Optional[float] = None,
                         seq_axis: str = "model"):
    """The ring on a cache stored sharded by sequence: q (b, Hq, Sq, D)
    this rank's batch rows, whole over ``seq_axis``; k, v (b, Hkv, chunk,
    D) this rank's chunk of a cache of ``skv`` rows, the chunks laid out
    in ``seq_axis`` order.  Returns this rank's rows of the result; no
    rank ever holds more than its chunk."""
    mesh = context.current_mesh()
    n = int(mesh.shape[seq_axis])
    sq, d = q.shape[2], q.shape[3]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    off = skv - sq if q_offset is None else q_offset
    return _ring_attention(q, k, v, off, mesh=mesh, axis=seq_axis, n=n,
                           chunk=k.shape[2], skv=skv, causal=causal,
                           window=window, scale=scale)
