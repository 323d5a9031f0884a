"""Layer implementations and parameter metadata of the model zoo (the port
of ``repro.models.layers``).

Parameters are plain nested dicts (and, for a stage's repeats, lists) of
tensors, described by ``ParamMeta`` (shape, logical axes, init) so that the
same table yields real parameters (``materialize``) and shape-only ones on
the ``meta`` device (``abstract``).  ``dist.sharding`` reads the logical
axes to shard the parameters over a mesh.

The routing of ``attention_call`` and ``mamba_block`` is the reference's:
self-attention with a cache (prefill, decode) and the Mamba recurrence
take the plain routes; the cache-free forward and every cross-attention
call (which has no ``q_offset``: its queries see the whole memory)
reach the kernels.  ``moe_block`` is plain torch, as the reference's is
plain XLA (it has no Pallas kernel).  Everything here is differentiable
on the plain route; the kernels have no backward and raise on inputs
that require grad.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.config import ModelConfig
from repro_torch.routing import group_limited_top_k, top_k  # noqa: F401

# ---------------------------------------------------------------------------
# Parameter metadata
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]   # logical axis names (sharding rules)
    dtype: Any = torch.float32
    init: str = "normal"              # normal|zeros|ones|a_log|dt_bias
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(f, *trees):
    """Map ``f`` over the leaves of nested dicts / lists / tuples of the
    same structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(f, *(t[i] for t in trees))
                        for i in range(len(t0)))
    return f(*trees)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _init_one(meta: ParamMeta, generator: torch.Generator, device):
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    if meta.init == "normal":
        return (torch.randn(meta.shape, **kw) * meta.scale).to(meta.dtype)
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=meta.dtype, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=meta.dtype, device=device)
    if meta.init == "a_log":  # A = -exp(a_log); a_log ~ log U[1, 16]
        u = torch.rand(meta.shape, **kw) * 15.0 + 1.0
        return torch.log(u).to(meta.dtype)
    if meta.init == "dt_bias":  # softplus^-1 of U[dt_min, dt_max]
        u = torch.rand(meta.shape, **kw) * (0.1 - 1e-3) + 1e-3
        return (u + torch.log(-torch.expm1(-u))).to(meta.dtype)
    raise ValueError(meta.init)


def materialize(metas, generator: torch.Generator, device) -> Any:
    """Real parameters from a ParamMeta tree, drawn from ``generator``
    (same distributions as the reference's, not the same numbers)."""
    return tree_map(lambda m: _init_one(m, generator, device), metas)


def abstract(metas) -> Any:
    """Shape-only parameters on the ``meta`` device (no allocation)."""
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                          device="meta"), metas)


def stack_metas(metas, repeats: int) -> list:
    """One copy of a unit's metas per repeat (the reference stacks them on
    a leading "layers" axis; the port keeps a list and loops)."""
    return [metas for _ in range(repeats)]


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------
def norm_meta(cfg: ModelConfig) -> dict:
    d = {"scale": ParamMeta((cfg.d_model,), (None,), init="ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamMeta((cfg.d_model,), (None,), init="zeros")
    return d


def _dtensor_mesh(x):
    """The ambient live mesh when ``x`` is a DTensor (the dry run's global
    program), else None: on plain tensors the layout hints are
    identities."""
    from repro_torch.dist import context
    mesh = context.current_mesh()
    if mesh is None or not mesh.live:
        return None
    from torch.distributed.tensor import DTensor
    return mesh if isinstance(x, DTensor) else None


def constrain_btd(cfg, x):
    """Shard a (B, S, d) activation per ``cfg.act_shard`` (the reference's
    GSPMD hint ``with_sharding_constraint``): on a DTensor under a live
    mesh it is redistributed to that layout (batch over the batch axes;
    ``model_seq`` the sequence, ``model_d`` the width over ``model``;
    ``none`` neither), which is where the reference's partitioner puts
    the collectives.  On plain tensors, and without a mesh, an identity:
    no value changes either way."""
    mesh = _dtensor_mesh(x)
    if mesh is None or x.dim() != 3:
        return x
    from repro_torch.dist import sharding as shd
    return shd.constrain(x, act_spec(cfg, mesh), mesh)


def act_spec(cfg, mesh):
    """The (B, S, d) activations' spec per ``cfg.act_shard`` (see
    ``constrain_btd``)."""
    from repro_torch.dist import sharding as shd
    b = shd.batch_axes(mesh)
    model = "model" if "model" in mesh.axis_names else None
    if cfg.act_shard == "model_seq":
        return shd.P(b, model, None)
    if cfg.act_shard == "model_d":
        return shd.P(b, None, model)
    return shd.P(b, None, None)


def constrain_inner(x, dim: int):
    """Shard an inner activation's ``dim`` (heads / ff / d_inner) over
    ``model`` where it divides, batch over the batch axes (the reference's
    Megatron hint); an identity on plain tensors, as ``constrain_btd``."""
    mesh = _dtensor_mesh(x)
    if mesh is None or "model" not in mesh.axis_names:
        return x
    from repro_torch.dist import sharding as shd
    parts = [shd.batch_axes(mesh)]
    parts += [None] * (x.dim() - 1)
    parts[dim] = "model"
    return shd.constrain(x, shd.P(*parts), mesh)


def _mean_last(x):
    """Mean over the last dimension.  A DTensor split there takes it as a
    sum over the width (a pending sum, not DTensor's pending average,
    whose gradient it cannot redistribute); plain tensors ``torch.mean``."""
    if _dtensor_mesh(x) is not None:
        return x.sum(dim=-1, keepdim=True) / x.shape[-1]
    return torch.mean(x, dim=-1, keepdim=True)


def apply_norm(cfg: ModelConfig, p, x):
    xf = constrain_btd(cfg, x.float())
    if cfg.norm == "rmsnorm":
        inv = torch.rsqrt(_mean_last(xf * xf) + 1e-6)
        out = xf * inv * p["scale"].float()
    else:
        mu = _mean_last(xf)
        var = _mean_last((xf - mu) ** 2)
        out = (xf - mu) * torch.rsqrt(var + 1e-6) * p["scale"].float() \
            + p["bias"].float()
    return constrain_btd(cfg, out).to(x.dtype)


def rope(q, k, positions, theta: float, q_positions=None):
    """Rotary embeddings on interleaved pairs (x[..., ::2], x[..., 1::2]),
    as the reference rotates them.  q/k: (B, H, S, D); positions: (S,) or
    (B, S); ``q_positions`` those of q where they differ from k's (a
    rank's rows of the sequence)."""
    d = q.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=q.device) / d))

    def rot(x, positions):
        if positions.dim() == 1:
            ang = positions.float()[:, None] * freqs[None, :]
            ang = ang[None, None]                       # (1,1,S,D/2)
        else:
            ang = positions.float()[..., None] * freqs
            ang = ang[:, None]                          # (B,1,S,D/2)
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., ::2], x[..., 1::2]
        xr1 = x1 * cos - x2 * sin
        xr2 = x2 * cos + x1 * sin
        return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)

    return (rot(q, positions if q_positions is None else q_positions),
            rot(k, positions))


# ---------------------------------------------------------------------------
# Attention block + MLP
# ---------------------------------------------------------------------------
def attn_meta(cfg: ModelConfig, cross: bool = False) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": ParamMeta((d, hq, hd), ("embed", "heads", None)),
        "wk": ParamMeta((d, hkv, hd), ("embed", "kv_heads", None)),
        "wv": ParamMeta((d, hkv, hd), ("embed", "kv_heads", None)),
        "wo": ParamMeta((hq, hd, d), ("heads", None, "embed")),
        "ln": norm_meta(cfg),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = ParamMeta((hq, hd), ("heads", None), init="zeros")
        p["bk"] = ParamMeta((hkv, hd), ("kv_heads", None), init="zeros")
        p["bv"] = ParamMeta((hkv, hd), ("kv_heads", None), init="zeros")
    return p


def mlp_meta(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wg": ParamMeta((d, ff), ("embed", "ff")),
            "wu": ParamMeta((d, ff), ("embed", "ff")),
            "wd": ParamMeta((ff, d), ("ff", "embed")),
            "ln": norm_meta(cfg),
        }
    return {
        "w1": ParamMeta((d, ff), ("embed", "ff")),
        "b1": ParamMeta((ff,), ("ff",), init="zeros"),
        "w2": ParamMeta((ff, d), ("ff", "embed")),
        "b2": ParamMeta((d,), (None,), init="zeros"),
        "ln": norm_meta(cfg),
    }


def apply_mlp(cfg: ModelConfig, p, x):
    y = apply_norm(cfg, p["ln"], x)
    mesh = _dtensor_mesh(y)
    if mesh is not None:
        return x + _mlp_sharded(cfg, p, y, mesh)
    return x + _mlp(cfg, p, y)


def _mlp(cfg: ModelConfig, p, y):
    if cfg.act == "swiglu":
        h = constrain_inner(F.silu(y @ p["wg"]) * (y @ p["wu"]), 2)
        return h @ p["wd"]
    # jax.nn.gelu's default is the tanh approximation
    h = constrain_inner(F.gelu(y @ p["w1"] + p["b1"], approximate="tanh"), 2)
    return h @ p["w2"] + p["b2"]


def _mlp_sharded(cfg: ModelConfig, p, y, mesh):
    """``_mlp`` on each rank's shards as ``sharding.mlp_specs`` splits
    them.  (The second bias joins once, outside the pending sum.)"""
    from repro_torch.dist import sharding as shd
    t = shd.mlp_specs(cfg, mesh, tuple(y.shape))
    specs = t["weights"]
    keys = sorted(k for k in p if k in specs)

    def body(yy, *ws):
        lp = dict(zip(keys, ws))
        if cfg.act == "swiglu":
            return (_mlp(cfg, lp, yy),)
        h = F.gelu(yy @ lp["w1"] + lp["b1"], approximate="tanh")
        return (h @ lp["w2"],)

    (out,) = shd.local_region(
        mesh, body, [(y, t["rows"])] + [(p[k], specs[k]) for k in keys],
        [t["rows"]], partial=(t["partial"],))
    return out if cfg.act == "swiglu" else out + p["b2"]


def _project_q(p, y):
    q = torch.einsum("btd,dhk->bhtk", y, p["wq"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
    return constrain_inner(q, 1)


def _project_kv(p, src):
    k = torch.einsum("btd,dhk->bhtk", src, p["wk"])
    v = torch.einsum("btd,dhk->bhtk", src, p["wv"])
    if "bk" in p:
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    return constrain_inner(k, 1), constrain_inner(v, 1)


def attention_call(cfg: ModelConfig, q, k, v, *, causal, window,
                   q_offset=None, ring=None, rows=None):
    """Dispatch as the reference does: under ``attn_impl="seq_shard"`` a
    one-row query (decode) goes to ``dist.decode_attn``'s
    sequence-sharded attention (the plain route without a mesh; under a
    live mesh k/v are this rank's chunk of a cache stored sharded by
    sequence, ``ring`` = (the whole cache's length, this rank's chunk
    offset), and ``rows`` the batch entry of the rows the chunk holds
    when q holds every row); a call with a ``q_offset`` (self-attention
    against a cache), ``"torch"`` or ``"seq_shard"`` takes the plain
    route (chunked above 1 024 queries); under ``"cuda"`` every other
    call reaches the kernel: the cache-free forward and every
    cross-attention call, prefill and decode included, at any length."""
    if cfg.attn_impl == "seq_shard" and q.shape[2] == 1:
        from repro_torch.dist import decode_attn
        return decode_attn.seq_sharded_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            skv=ring[0] if ring is not None else None, rows=rows)
    if q_offset is not None or cfg.attn_impl in ("torch", "seq_shard"):
        if q.shape[2] > 1024:
            return kref.attention_chunked(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset)
        return kref.attention_ref(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    return kops.attention(q, k, v, causal=causal, window=window,
                          impl=cfg.attn_impl)


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where a rank's shard of an attention block sits in the global one
    (all zero / None on one device): ``row0`` the global position of its
    first query row, ``kv`` the slice of the K/V heads its query heads
    read (None: all it holds), ``chunk`` (the cache's global length, this
    rank's offset in it) for a cache stored sharded by sequence, and
    ``rows`` the batch entry of the rows such a cache holds when the
    block's activations hold every row (plain tensors under a live mesh,
    ``_plain_layout``)."""
    row0: int = 0
    kv: Optional[slice] = None
    chunk: Optional[tuple[int, int]] = None
    rows: Any = None


def _plain_layout(cfg: ModelConfig, cache, cross: bool, batch: int):
    """The layout of a plain-tensor self-attention cache: under a live
    mesh whose ``model`` axis has n > 1 ranks and ``attn_impl=
    "seq_shard"``, each rank holds its chunk of the sequence and its
    batch rows (``sharding.shard_cache``, the DTensor caches' layout),
    the whole cache n chunks long; else the whole cache."""
    if cache is None or cross or cfg.attn_impl != "seq_shard":
        return _Layout()
    from repro_torch.dist import decode_attn, sharding
    mesh = decode_attn.seq_mesh()
    if mesh is None:
        return _Layout()
    n, chunk = int(mesh.shape["model"]), cache["k"].shape[2]
    return _Layout(chunk=(n * chunk, mesh.coordinate()["model"] * chunk),
                   rows=sharding.batch_entry(mesh, batch))


def _write_cache(cache, k, v, pos: int, off: int = 0, donate: bool = False):
    """The cache with k/v (B, Hkv, s, hd) written at rows ``pos``..``pos +
    s``.  ``donate``: the step owns the cache, so the rows are written
    into it and its own tensors come back (the reference's donated
    buffers); else into new tensors, the caller's cache left as it was
    (the reference's functional update).  ``off``: the global row of the
    cache's first row (a rank's chunk of a sequence-sharded cache), which
    takes only the rows that fall in it."""
    ck, cv = cache["k"], cache["v"]
    if not donate:
        ck, cv = ck.clone(), cv.clone()
    s, n = k.shape[2], ck.shape[2]
    lo, hi = max(pos, off), min(pos + s, off + n)
    if lo < hi:
        ck[:, :, lo - off:hi - off] = k[:, :, lo - pos:hi - pos].to(ck.dtype)
        cv[:, :, lo - off:hi - off] = v[:, :, lo - pos:hi - pos].to(cv.dtype)
    return ck, cv


def _attention(cfg: ModelConfig, p, yq, ykv, *, causal, window, positions,
               cross, memory, cache, pos, donate: bool = False,
               lay: _Layout = _Layout()):
    """The attention block between its norm and its residual: queries
    from ``yq``, keys and values from ``ykv`` (the same rows on one
    device), rope, the cache write, attention and the output projection.
    Returns (out (B, Sq, d), new_cache_or_None)."""
    sq = yq.shape[1]
    q = _project_q(p, yq)
    new_cache = None
    q_offset = None
    if cross:
        if memory is not None:
            k, v = _project_kv(p, memory.to(yq.dtype))
            if cache is not None:
                new_cache = {n: t.to(cache[n].dtype)
                             for n, t in (("k", k), ("v", v))}
                if donate:
                    new_cache = {n: cache[n].copy_(t)
                                 for n, t in new_cache.items()}
        else:
            if cache is None:
                raise ValueError("cross-attention decode needs a prefilled "
                                 "cache or a memory")
            k, v = cache["k"], cache["v"]
            new_cache = cache
        causal = False
    else:
        k, v = _project_kv(p, ykv)
        if positions is None:
            positions = torch.arange(ykv.shape[1], device=yq.device)
        q_pos = None if sq == ykv.shape[1] else \
            positions[..., lay.row0:lay.row0 + sq]
        q, k = rope(q, k, positions, cfg.rope_theta, q_positions=q_pos)
        if cache is not None:
            src = (k, v)
            if lay.rows is not None:    # the rows this rank's cache holds
                from repro_torch.dist import context, sharding
                mesh = context.current_mesh()
                src = tuple(sharding.local_rows(mesh, t, lay.rows)
                            for t in src)
            ck, cv = _write_cache(cache, *src, pos,
                                  lay.chunk[1] if lay.chunk else 0, donate)
            del src     # k and v are rebound below: hold no copy of them
            new_cache = {"k": ck, "v": cv}
            q_offset = pos + lay.row0
            if lay.chunk is None or sq == 1:
                k, v = ck, cv
            elif pos != 0:
                raise NotImplementedError(
                    "a prompt after position 0 against a cache stored "
                    "sharded by sequence")
            else:
                # a prefill from 0 attends over its own rows (all of them
                # here; the cache's later rows are zeros it cannot see),
                # in the cache's dtype, as read back from a whole cache
                k, v = k.to(ck.dtype), v.to(cv.dtype)
        elif causal and sq < k.shape[2]:
            # a rank's query rows (``seq``): it reads every key under the
            # mask, as the reference's one SPMD program does, so every
            # rank does rank 0's work
            q_offset = lay.row0
    if lay.kv is not None:
        k, v = k[:, lay.kv], v[:, lay.kv]
    out = attention_call(cfg, q, k, v, causal=causal, window=window,
                         q_offset=q_offset,
                         ring=lay.chunk if not cross else None,
                         rows=lay.rows)
    return torch.einsum("bhtk,hkd->btd", out.to(yq.dtype), p["wo"]), \
        new_cache


def attn_block(cfg: ModelConfig, p, x, *, causal=True, window=None,
               positions=None, cross: bool = False, memory=None, cache=None,
               pos=None, donate: bool = False):
    """Self- or cross-attention block (pre-norm, residual).

    Self-attention: cache dict(k=(B,Hkv,Smax,hd), v=...), written at
    ``pos`` into a new tensor (the caller's cache is left as it was, as
    the reference's functional update leaves it), or, ``donate``, into
    the cache itself (``_write_cache``).  Under a live mesh with
    ``attn_impl="seq_shard"`` a plain-tensor cache holds this rank's
    chunk (``_plain_layout``).  Cross-attention (no
    rope, not causal): with ``memory`` the K/V are projected from it (and
    stored to the cache when one is given — prefill); without ``memory``
    the cached K/V are used (decode).  On DTensors under a live mesh the
    block between norm and residual runs on each rank's shards
    (``_attn_sharded``).  Returns (x, new_cache_or_None)."""
    y = apply_norm(cfg, p["ln"], x)
    kw = dict(causal=causal, window=window, positions=positions,
              cross=cross, memory=memory, cache=cache, pos=pos,
              donate=donate)
    mesh = _dtensor_mesh(y)
    if mesh is None:
        out, new_cache = _attention(
            cfg, p, y, y, **kw,
            lay=_plain_layout(cfg, cache, cross, y.shape[0]))
    else:
        out, new_cache = _attn_sharded(cfg, p, y, mesh, **kw)
    return x + out, new_cache


def _attn_sharded(cfg: ModelConfig, p, y, mesh, **kw):
    """``_attention`` on each rank's shards (``sharding.local_region``) in
    the mode that ``sharding.attn_specs`` picks (``heads``, ``ring``,
    ``seq`` or ``replicated``), with the ``_Layout`` of the rank's shard
    in that mode."""
    from repro_torch.dist import sharding as shd
    cache, cross = kw["cache"], kw["cross"]
    m = shd.model_size(mesh)
    hq, hkv, s = cfg.n_heads, cfg.n_kv_heads, y.shape[1]
    c = mesh.coordinate()["model"] if m > 1 else 0
    t = shd.attn_specs(cfg, mesh, s, ring=cfg.attn_impl == "seq_shard"
                       and cache is not None and not cross)
    mode = t["mode"]
    lay = _Layout()
    if mode == "heads" and t["kv_split"] is None:
        group, hq_l = hq // hkv, hq // m
        lay = _Layout(kv=slice(c * hq_l // group,
                               (c * hq_l + hq_l - 1) // group + 1))
    elif mode == "seq":
        lay = _Layout(row0=c * (s // m))
    elif mode == "ring":
        total = cache["k"].shape[2]
        lay = _Layout(chunk=(total, c * (total // m)))

    def fit(spec, x):
        return shd.fit_spec(spec, tuple(x.shape), mesh)

    w_specs = t["weights"]
    pw = {k: v for k, v in p.items() if k in w_specs}
    y_q, y_kv, c_spec = t["q"], t["kv"], t["cache"]
    inputs = [(y, fit(y_q, y)), (y, fit(y_kv, y)),
              (kw["memory"], None if kw["memory"] is None
               else fit(y_kv, kw["memory"]))]
    inputs += [(pw[k], fit(w_specs[k], pw[k])) for k in sorted(pw)]
    c_keys = sorted(cache) if cache is not None else []
    inputs += [(cache[k], fit(c_spec, cache[k])) for k in c_keys]
    out_spec = fit(y_q, y)

    def body(yq, ykv, memory, *rest):
        local_p = dict(zip(sorted(pw), rest[:len(pw)]))
        local_c = dict(zip(c_keys, rest[len(pw):])) if cache is not None \
            else None
        out, nc = _attention(cfg, local_p, yq, ykv,
                             **{**kw, "memory": memory, "cache": local_c},
                             lay=lay)
        return (out,) + tuple(nc[k] for k in c_keys) if nc else (out,)

    c_specs = [fit(c_spec, cache[k]) for k in c_keys]
    pend = (t["partial"],) + ((),) * len(c_keys)
    outs = shd.local_region(mesh, body, inputs, [out_spec] + c_specs,
                            partial=pend)
    new_cache = dict(zip(c_keys, outs[1:])) if cache is not None else None
    return outs[0], new_cache


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-bounded scatter dispatch)
# ---------------------------------------------------------------------------
def moe_meta(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    e = cfg.moe
    p = {
        "router": ParamMeta((d, e.n_experts), ("embed", "experts")),
        "wg": ParamMeta((e.n_experts, d, e.d_ff_expert),
                        ("experts", "embed", "expert_ff")),
        "wu": ParamMeta((e.n_experts, d, e.d_ff_expert),
                        ("experts", "embed", "expert_ff")),
        "wd": ParamMeta((e.n_experts, e.d_ff_expert, d),
                        ("experts", "expert_ff", "embed")),
        "ln": norm_meta(cfg),
    }
    if e.shared_expert:
        p["shared"] = {k: v for k, v in
                       mlp_meta(cfg, d_ff=e.d_ff_expert).items()
                       if k != "ln"}
    return p


def moe_block(cfg: ModelConfig, p, x):
    """Token-choice top-k MoE with capacity-bounded scatter dispatch.

    Each of the T*k (token, choice) pairs, in token-major order, takes the
    next free slot of its expert (a running count); pairs past the
    capacity fall through on the residual, adding zeros at slot cap - 1.
    Tokens are scattered into an (E, C, d) buffer, the experts run as
    grouped einsums, and the outputs are gathered back and combined with
    their routing weights.  Everything stays on the device: masks are
    ``torch.where``, never boolean indexing.  Returns (x, aux), aux the
    Switch-style load-balance loss of the first choices.

    On DTensors under a live mesh (``_moe_sharded``) the experts split
    over ``model`` (expert parallelism: every ``model`` rank routes its
    batch rows alike and runs its own experts, the combined outputs a
    pending sum over ``model``) and the shared expert is Megatron-split;
    routing, capacity and the auxiliary loss are the global batch's, as
    in the reference's one program (``_moe_routed``'s ``shards``)."""
    y = apply_norm(cfg, p["ln"], x)
    mesh = _dtensor_mesh(y)
    if mesh is not None:
        routed, shared, aux = _moe_sharded(cfg, p, y, mesh)
        out = x + routed.to(x.dtype)
        return (out if shared is None else out + shared.to(x.dtype)), aux
    e = cfg.moe
    routed, aux = _moe_routed(cfg, p, y)
    out = x + routed.to(x.dtype)
    if e.shared_expert:
        out = out + _shared_expert(p["shared"], y).to(x.dtype)
    return out, aux


def _shared_expert(sp, y):
    return (F.silu(y @ sp["wg"]) * (y @ sp["wu"])) @ sp["wd"]


def _moe_routed(cfg: ModelConfig, p, y, e0: int = 0, shards=None):
    """The routed experts' combined output (B, S, d) and the auxiliary
    loss, over the experts ``e0`` .. ``e0 + p["wg"].shape[0]`` (all of
    them on one device): choices of other experts add nothing.

    ``shards`` = (process group, this rank's index, n): ``y`` is this
    rank's block of rows of a batch split n ways (``_moe_sharded``), and
    the routing is the global batch's, as the reference's one program
    routes it: the capacity from the global token count, each pair's
    slot its place in the global token-major order (this rank's running
    count plus the counts of the lower ranks, one all-gather of an (E,)
    vector), the auxiliary loss from the global means.  The expert
    buffer holds this rank's pairs only, at their places among its own
    (at most ``min(capacity, T * k)`` of them per expert)."""
    e = cfg.moe
    b, s, d = y.shape
    t = b * s
    n = 1 if shards is None else shards[2]
    yt = y.reshape(t, d)

    gates, weights, experts, onehot, slot = _route(cfg, p, yt)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                    min=1e-9)
    cap = moe_capacity(cfg, t * n)
    flat_e = experts.reshape(-1)                               # (T*k,)
    if shards is None:
        rows, fits = cap, slot < cap
    else:
        from repro_torch.dist import collectives
        group, index, _ = shards
        every = collectives.all_gather(onehot.sum(0)[None], group)  # (n, E)
        below = every[:index].sum(0)
        rows, fits = min(cap, t * e.top_k), slot + below[flat_e] < cap
    n_local = p["wg"].shape[0]
    mine = (flat_e >= e0) & (flat_e < e0 + n_local)
    keep = fits & mine
    slot_c = torch.where(fits, slot, rows - 1)
    local_e = torch.where(mine, flat_e - e0, 0)

    tok_idx = torch.arange(t, device=y.device).repeat_interleave(e.top_k)
    buf = torch.zeros((n_local, rows, d), dtype=y.dtype, device=y.device)
    buf.index_put_((local_e, slot_c),
                   torch.where(keep[:, None], yt[tok_idx], 0),
                   accumulate=True)

    h = torch.einsum("ecd,edf->ecf", buf, p["wg"])
    h = F.silu(h) * torch.einsum("ecd,edf->ecf", buf, p["wu"])
    out_buf = torch.einsum("ecf,efd->ecd", h, p["wd"])         # (E, C, d)

    gathered = out_buf[local_e, slot_c]                        # (T*k, d)
    gathered = torch.where(keep[:, None], gathered, 0)
    wflat = weights.reshape(-1)
    combined = torch.zeros((t, d), dtype=gathered.dtype, device=y.device)
    combined.index_add_(0, tok_idx,
                        gathered * wflat[:, None].to(gathered.dtype))

    # load-balance auxiliary loss (Switch-style), first choices only
    first = F.one_hot(experts[:, 0], e.n_experts).float()
    if shards is None:
        me, ce = torch.mean(first, dim=0), torch.mean(gates, dim=0)
    else:
        from repro_torch.dist import collectives
        me = collectives.psum_replicated(first.sum(0), shards[0]) / (t * n)
        ce = collectives.psum_replicated(gates.sum(0), shards[0]) / (t * n)
    aux = e.n_experts * torch.sum(me * ce)
    return combined.reshape(b, s, d), aux


def _route(cfg: ModelConfig, p, yt):
    """The router on tokens ``yt`` (T, d): gates (T, E) float32, the top-k
    gates and experts (T, k), and for each (token, choice) pair in
    token-major order its expert's one-hot (T*k, E) and its slot, the
    count of earlier pairs of that expert."""
    gates = torch.softmax((yt @ p["router"]).float(), dim=-1)
    weights, experts = top_k(gates, cfg.moe.top_k)
    flat_e = experts.reshape(-1)
    onehot = F.one_hot(flat_e, cfg.moe.n_experts)
    slot = torch.gather(torch.cumsum(onehot, dim=0), 1,
                        flat_e[:, None])[:, 0] - 1
    return gates, weights, experts, onehot, slot


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for a batch of ``tokens`` tokens (the
    reference's rule)."""
    e = cfg.moe
    return max(math.ceil(tokens * e.top_k * e.capacity_factor
                         / e.n_experts), 4)


def moe_dropped(cfg: ModelConfig, p, x) -> int:
    """How many (token, choice) pairs of ``moe_block(cfg, p, x)`` on one
    device fall past their expert's capacity (a check that capacity
    binds; a host sync)."""
    y = apply_norm(cfg, p["ln"], x)
    yt = y.reshape(-1, y.shape[-1])
    slot = _route(cfg, p, yt)[-1]
    return int((slot >= moe_capacity(cfg, yt.shape[0])).sum())


def _moe_sharded(cfg: ModelConfig, p, y, mesh):
    """``moe_block``'s parts on each rank's shards (see its docstring):
    returns (routed output, shared expert's output or None, aux)."""
    from repro_torch.dist import sharding as shd
    e = cfg.moe
    t = shd.moe_specs(cfg, mesh, tuple(y.shape))
    e0 = mesh.coordinate()["model"] * (e.n_experts // shd.model_size(mesh)) \
        if t["experts"] else 0
    rows = t["rows"]
    split = shd.entry_axes(rows[0])
    shards = (mesh.group(split), mesh.index(split),
              math.prod(int(mesh.shape[a]) for a in split)) if split \
        else None
    w = t["expert"]
    routed, aux = shd.local_region(
        mesh, lambda yy, r, wg, wu, wd: _moe_routed(
            cfg, {"router": r, "wg": wg, "wu": wu, "wd": wd}, yy, e0,
            shards),
        [(y, rows), (p["router"], t["router"]), (p["wg"], w),
         (p["wu"], w), (p["wd"], w)],
        [rows, shd.P()], partial=(t["partial"], ()))
    if not e.shared_expert:
        return routed, None, aux
    sp, st = p["shared"], t["shared"]
    (shared,) = shd.local_region(
        mesh, lambda yy, wg, wu, wd: (_shared_expert(
            {"wg": wg, "wu": wu, "wd": wd}, yy),),
        [(y, rows)] + [(sp[k], st["weights"][k]) for k in ("wg", "wu", "wd")],
        [rows], partial=(st["partial"],))
    return routed, shared, aux


# ---------------------------------------------------------------------------
# Mamba-2 SSD block
# ---------------------------------------------------------------------------
def mamba_meta(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    s = cfg.ssm
    di = cfg.d_inner
    h = cfg.n_ssm_heads
    gn = s.n_groups * s.d_state
    return {
        "wz": ParamMeta((d, di), ("embed", "inner")),
        "wx": ParamMeta((d, di), ("embed", "inner")),
        "wb": ParamMeta((d, gn), ("embed", None)),
        "wc": ParamMeta((d, gn), ("embed", None)),
        "wdt": ParamMeta((d, h), ("embed", None)),
        "conv_x": ParamMeta((di, s.conv_width), ("inner", None),
                            scale=0.2),
        "conv_b": ParamMeta((gn, s.conv_width), (None, None), scale=0.2),
        "conv_c": ParamMeta((gn, s.conv_width), (None, None), scale=0.2),
        "a_log": ParamMeta((h,), (None,), init="a_log"),
        "dt_bias": ParamMeta((h,), (None,), init="dt_bias"),
        "d_skip": ParamMeta((h,), (None,), init="ones"),
        "gate_norm": ParamMeta((di,), ("inner",), init="ones"),
        "wo": ParamMeta((di, d), ("inner", "embed")),
        "ln": norm_meta(cfg),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: (B, S, C), w: (C, W).
    state: (B, W-1, C) previous inputs for decode. Returns (y, new_state).
    The taps are summed in float32 and rounded once, as a dot does."""
    b, s, c = x.shape
    cw = w.shape[-1]
    pad = state if state is not None else torch.zeros(
        (b, cw - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)                    # (B, S+W-1, C)
    wf = w.float()
    y = sum(xp[:, j:j + s, :].float() * wf[:, j] for j in range(cw))
    new_state = xp[:, -(cw - 1):, :] if cw > 1 else pad
    return y.to(torch.promote_types(xp.dtype, w.dtype)), new_state


def mamba_block(cfg: ModelConfig, p, x, *, cache=None, fresh=False,
                donate: bool = False):
    """Mamba-2 block. cache: dict(conv_x/conv_b/conv_c states, ssm state
    (B, H, N, P)).  Without a cache the chunked SSD runs through
    ``ops.ssd`` (the kernel under ``attn_impl="cuda"``); with one, the
    per-token recurrence, or, ``fresh`` (a prefill from position 0), the
    scan and the final state in closed form; ``donate``: the new states
    are written into the cache's own tensors, which come back.  On
    DTensors under a live
    mesh the input projections and the mixer (the convolutions, the scan
    and the skip) run on each rank's shards, the heads and ``d_inner``
    split over ``model`` where they divide (``_mamba_sharded``), and so
    does the output projection.  Returns (x, new_cache_or_None)."""
    y = apply_norm(cfg, p["ln"], x)
    mesh = _dtensor_mesh(y)
    if mesh is None:
        z, xs, bs, cs, dt = _mamba_in(p, y)
        yflat, new_cache = _mamba_mixer(cfg, p, xs, bs, cs, dt, cache,
                                        fresh, donate)
    else:
        z, yflat, new_cache = _mamba_sharded(cfg, p, y, cache, mesh, fresh,
                                             donate)
    # gated RMSNorm (Mamba-2), in float32
    inv = torch.rsqrt(_mean_last(yflat * yflat) + 1e-6)
    yflat = yflat * inv * p["gate_norm"].float()
    yflat = yflat * F.silu(z.float())
    if mesh is None:
        return x + (yflat @ p["wo"].float()).to(x.dtype), new_cache
    return x + _mamba_out_sharded(cfg, p, yflat, mesh).to(x.dtype), \
        new_cache


def _mamba_in(p, y):
    """The input projections: z, x, B, C and dt = softplus(. + bias)."""
    dt = F.softplus((y @ p["wdt"]).float() + p["dt_bias"].float())  # (B,S,H)
    return y @ p["wz"], y @ p["wx"], y @ p["wb"], y @ p["wc"], dt


def _mamba_out_sharded(cfg: ModelConfig, p, yflat, mesh):
    """The output projection on each rank's shards
    (``sharding.mamba_specs``): ``d_inner``'s rows of ``wo`` as split with
    the heads, the product a pending sum."""
    from repro_torch.dist import sharding as shd
    t = shd.mamba_specs(cfg, mesh)
    bsz, s, _ = yflat.shape
    inner = shd.fit_spec(t["inner"], tuple(yflat.shape), mesh)
    rows = shd.fit_spec(t["rows"], (bsz, s, cfg.d_model), mesh)
    (out,) = shd.local_region(
        mesh, lambda yf, wo: (yf @ wo.float(),),
        [(yflat, inner), (p["wo"], t["wo"])], [rows],
        partial=(t["partial"],))
    return out


def _final_state(xh, dth, a, bh):
    """The SSM state after a sequence from a zero state: sum over t of
    exp(a * (dt_{t+1} + ... + dt_S)) dt_t B_t x_t^T (the recurrence
    unrolled), (B, H, N, P) float32."""
    cum = torch.cumsum(dth * a[None, :, None], dim=-1)         # (B,H,S)
    w = torch.exp(cum[..., -1:] - cum) * dth
    bhh = bh.repeat_interleave(xh.shape[1] // bh.shape[1], dim=1).float()
    return (w[..., None] * bhh).transpose(-1, -2) @ xh.float()


def _mamba_mixer(cfg: ModelConfig, p, xs, bs, cs, dt, cache,
                 fresh: bool = False, donate: bool = False):
    """The causal convolutions, the SSD scan (or the recurrence against
    the cache) and the skip: (B, S, H * P) float32 and the new cache.
    ``fresh``: the cache holds a zero state (a prefill from position 0),
    so the outputs come from the chunked scan (its plain version: a
    prefill takes the plain routes, as in the reference) and the new
    state in closed form (``_final_state``), not from a step per
    token.  ``donate``: the new states go into the cache's tensors."""
    s_cfg = cfg.ssm
    b, s, _ = xs.shape
    h, pdim, n = dt.shape[-1], s_cfg.head_dim, s_cfg.d_state
    g = s_cfg.n_groups
    new_cache = None
    if cache is None:
        xs, _ = _causal_conv(xs, p["conv_x"])
        bs, _ = _causal_conv(bs, p["conv_b"])
        cs, _ = _causal_conv(cs, p["conv_c"])
    else:
        xs, cx = _causal_conv(xs, p["conv_x"], cache["conv_x"])
        bs, cb = _causal_conv(bs, p["conv_b"], cache["conv_b"])
        cs, cc = _causal_conv(cs, p["conv_c"], cache["conv_c"])
    xs, bs, cs = F.silu(xs), F.silu(bs), F.silu(cs)

    xh = xs.reshape(b, s, h, pdim).transpose(1, 2)              # (B,H,S,P)
    bh = bs.reshape(b, s, g, n).transpose(1, 2)                 # (B,G,S,N)
    ch = cs.reshape(b, s, g, n).transpose(1, 2)
    dth = dt.transpose(1, 2)                                    # (B,H,S)
    a = -torch.exp(p["a_log"].float())                          # (H,)

    if cache is None or fresh:
        # a prefill (with a cache) keeps the reference's plain route
        yh = kops.ssd(xh, dth, a, bh, ch, chunk=s_cfg.chunk,
                      impl=cfg.attn_impl if cache is None else "torch")
        if cache is not None:
            new_cache = {"conv_x": cx, "conv_b": cb, "conv_c": cc,
                         "ssm": _final_state(xh, dth, a, bh)}
    else:
        # single-step (or short-step) recurrence against the cached state
        state = cache["ssm"]                                    # (B,H,N,P)
        rep = h // g
        bhh = bh.repeat_interleave(rep, dim=1).float()
        chh = ch.repeat_interleave(rep, dim=1).float()
        xf = xh.float()
        da = torch.exp(dth * a[None, :, None])
        ys = []
        for t in range(s):
            dbx = (dth[:, :, t, None, None] * bhh[:, :, t, :, None]
                   * xf[:, :, t, None, :])
            if donate:    # the step owns the cache: update it in place
                state = state.mul_(da[:, :, t, None, None]).add_(dbx)
            else:
                state = da[:, :, t, None, None] * state + dbx
            ys.append(torch.einsum("bhnp,bhn->bhp", state, chh[:, :, t]))
        yh = torch.stack(ys, dim=2)                             # (B,H,S,P)
        new_cache = {"conv_x": cx, "conv_b": cb, "conv_c": cc, "ssm": state}

    if donate and new_cache is not None:
        new_cache = {k: t if t is cache[k] else cache[k].copy_(t)
                     for k, t in new_cache.items()}
    yh = yh.float() + p["d_skip"].float()[None, :, None, None] * xh.float()
    return yh.transpose(1, 2).reshape(b, s, h * pdim), new_cache


def _mamba_sharded(cfg: ModelConfig, p, y, cache, mesh,
                   fresh: bool = False, donate: bool = False):
    """``_mamba_in`` and ``_mamba_mixer`` on each rank's shards, as
    ``sharding.mamba_specs`` splits them.  Returns (z, the mixer's
    output, the new cache or None)."""
    from repro_torch.dist import sharding as shd
    t = shd.mamba_specs(cfg, mesh)

    def fit(spec, shape):
        return shd.fit_spec(spec, tuple(shape), mesh)
    rows, inner = t["rows"], t["inner"]
    specs, c_specs = t["weights"], t["cache"]
    keys = list(specs)
    c_keys = sorted(cache) if cache is not None else []
    inputs = [(y, fit(rows, y.shape))]
    inputs += [(p[k], fit(specs[k], p[k].shape)) for k in keys]
    inputs += [(cache[k], fit(c_specs[k], cache[k].shape)) for k in c_keys]

    def body(yy, *rest):
        lp = dict(zip(keys, rest[:len(keys)]))
        lc = dict(zip(c_keys, rest[len(keys):])) if c_keys else None
        z, xs, bs, cs, dt = _mamba_in(lp, yy)
        yflat, nc = _mamba_mixer(cfg, lp, xs, bs, cs, dt, lc, fresh,
                                 donate)
        return (z, yflat) + tuple(nc[k] for k in c_keys)

    inner_out = fit(inner, (*y.shape[:2], cfg.d_inner))
    outs = shd.local_region(
        mesh, body, inputs, [inner_out, inner_out]
        + [fit(c_specs[k], cache[k].shape) for k in c_keys])
    return outs[0], outs[1], \
        (dict(zip(c_keys, outs[2:])) if c_keys else None)
