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


def constrain_btd(cfg, x):
    """Identity, under a live mesh too.  The reference's version is a GSPMD
    layout hint (``with_sharding_constraint`` per ``cfg.act_shard``) for
    the compiler that partitions its global program; it changes no value.
    The port has no such compiler: its model runs per rank on local
    tensors, as the reference's ``shard_map`` bodies run under
    ``suspend_mesh``, where the hint is a no-op as well."""
    return x


def constrain_inner(x, dim: int):
    """Identity, as ``constrain_btd`` (the reference's hint to shard an
    inner activation's ``dim`` over ``model``)."""
    return x


def apply_norm(cfg: ModelConfig, p, x):
    xf = x.float()
    if cfg.norm == "rmsnorm":
        inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
        out = xf * inv * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-6) * p["scale"].float() \
            + p["bias"].float()
    return out.to(x.dtype)


def rope(q, k, positions, theta: float):
    """Rotary embeddings on interleaved pairs (x[..., ::2], x[..., 1::2]),
    as the reference rotates them.  q/k: (B, H, S, D); positions: (S,) or
    (B, S)."""
    d = q.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=q.device) / d))
    if positions.dim() == 1:
        ang = positions.float()[:, None] * freqs[None, :]
        ang = ang[None, None]                       # (1,1,S,D/2)
    else:
        ang = positions.float()[..., None] * freqs
        ang = ang[:, None]                          # (B,1,S,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)

    def rot(x):
        x1, x2 = x[..., ::2], x[..., 1::2]
        xr1 = x1 * cos - x2 * sin
        xr2 = x2 * cos + x1 * sin
        return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)


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
    if cfg.act == "swiglu":
        h = F.silu(y @ p["wg"]) * (y @ p["wu"])
        return x + h @ p["wd"]
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(y @ p["w1"] + p["b1"], approximate="tanh")
    return x + (h @ p["w2"] + p["b2"])


def _project_q(p, y):
    q = torch.einsum("btd,dhk->bhtk", y, p["wq"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
    return q


def _project_kv(p, src):
    k = torch.einsum("btd,dhk->bhtk", src, p["wk"])
    v = torch.einsum("btd,dhk->bhtk", src, p["wv"])
    if "bk" in p:
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    return k, v


def attention_call(cfg: ModelConfig, q, k, v, *, causal, window,
                   q_offset=None):
    """Dispatch as the reference does: under ``attn_impl="seq_shard"`` a
    one-row query (decode) goes to ``dist.decode_attn``'s
    sequence-sharded attention (the plain route without a mesh); a call
    with a ``q_offset`` (self-attention against a cache), ``"torch"`` or
    ``"seq_shard"`` takes the plain route (chunked above 1 024 queries);
    under ``"cuda"`` every other call reaches the kernel: the cache-free
    forward and every cross-attention call, prefill and decode included,
    at any length."""
    if cfg.attn_impl == "seq_shard" and q.shape[2] == 1:
        from repro_torch.dist import decode_attn
        return decode_attn.seq_sharded_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q_offset is not None or cfg.attn_impl in ("torch", "seq_shard"):
        if q.shape[2] > 1024:
            return kref.attention_chunked(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset)
        return kref.attention_ref(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    return kops.attention(q, k, v, causal=causal, window=window,
                          impl=cfg.attn_impl)


def attn_block(cfg: ModelConfig, p, x, *, causal=True, window=None,
               positions=None, cross: bool = False, memory=None, cache=None,
               pos=None):
    """Self- or cross-attention block (pre-norm, residual).

    Self-attention: cache dict(k=(B,Hkv,Smax,hd), v=...), written at
    ``pos`` into a new tensor (the caller's cache is left as it was, as
    the reference's functional update leaves it).  Cross-attention (no
    rope, not causal): with ``memory`` the K/V are projected from it (and
    stored to the cache when one is given — prefill); without ``memory``
    the cached K/V are used (decode).  Returns (x, new_cache_or_None)."""
    s = x.shape[1]
    y = apply_norm(cfg, p["ln"], x)
    q = _project_q(p, y)
    new_cache = None
    q_offset = None
    if cross:
        if memory is not None:
            k, v = _project_kv(p, memory.to(y.dtype))
            if cache is not None:
                new_cache = {"k": k.to(cache["k"].dtype),
                             "v": v.to(cache["v"].dtype)}
        else:
            if cache is None:
                raise ValueError("cross-attention decode needs a prefilled "
                                 "cache or a memory")
            k, v = cache["k"], cache["v"]
            new_cache = cache
        causal = False
    else:
        k, v = _project_kv(p, y)
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q, k = rope(q, k, positions, cfg.rope_theta)
        if cache is not None:
            ck, cv = cache["k"].clone(), cache["v"].clone()
            ck[:, :, pos:pos + s] = k.to(ck.dtype)
            cv[:, :, pos:pos + s] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv}
            k, v = ck, cv
            q_offset = pos
    out = attention_call(cfg, q, k, v, causal=causal, window=window,
                         q_offset=q_offset)
    x = x + torch.einsum("bhtk,hkd->btd", out.to(x.dtype), p["wo"])
    return x, new_cache


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


def top_k(gates, k: int):
    """The k largest gates per row and their expert ids, ties broken
    towards the lower id as ``jax.lax.top_k`` breaks them (a stable
    descending sort; ``torch.topk`` promises no order among equals)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(cfg: ModelConfig, p, x):
    """Token-choice top-k MoE with capacity-bounded scatter dispatch.

    Each of the T*k (token, choice) pairs, in token-major order, takes the
    next free slot of its expert (a running count); pairs past the
    capacity fall through on the residual, adding zeros at slot cap - 1.
    Tokens are scattered into an (E, C, d) buffer, the experts run as
    grouped einsums, and the outputs are gathered back and combined with
    their routing weights.  Everything stays on the device: masks are
    ``torch.where``, never boolean indexing.  Returns (x, aux), aux the
    Switch-style load-balance loss of the first choices."""
    e = cfg.moe
    b, s, d = x.shape
    y = apply_norm(cfg, p["ln"], x)
    t = b * s
    yt = y.reshape(t, d)

    logits = (yt @ p["router"]).float()
    gates = torch.softmax(logits, dim=-1)                      # (T, E)
    weights, experts = top_k(gates, e.top_k)                   # (T, k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                    min=1e-9)

    cap = max(math.ceil(t * e.top_k * e.capacity_factor / e.n_experts), 4)
    flat_e = experts.reshape(-1)                               # (T*k,)
    onehot = F.one_hot(flat_e, e.n_experts)
    slot = torch.gather(torch.cumsum(onehot, dim=0), 1,
                        flat_e[:, None])[:, 0] - 1             # (T*k,)
    keep = slot < cap
    slot_c = torch.where(keep, slot, cap - 1)

    tok_idx = torch.arange(t, device=x.device).repeat_interleave(e.top_k)
    buf = torch.zeros((e.n_experts, cap, d), dtype=y.dtype, device=x.device)
    buf.index_put_((flat_e, slot_c),
                   torch.where(keep[:, None], yt[tok_idx], 0),
                   accumulate=True)

    h = torch.einsum("ecd,edf->ecf", buf, p["wg"])
    h = F.silu(h) * torch.einsum("ecd,edf->ecf", buf, p["wu"])
    out_buf = torch.einsum("ecf,efd->ecd", h, p["wd"])         # (E, C, d)

    gathered = out_buf[flat_e, slot_c]                         # (T*k, d)
    gathered = torch.where(keep[:, None], gathered, 0)
    wflat = weights.reshape(-1)
    combined = torch.zeros((t, d), dtype=gathered.dtype, device=x.device)
    combined.index_add_(0, tok_idx,
                        gathered * wflat[:, None].to(gathered.dtype))

    out = x + combined.reshape(b, s, d).to(x.dtype)
    if e.shared_expert:
        sp = p["shared"]
        hs = F.silu(y @ sp["wg"]) * (y @ sp["wu"])
        out = out + (hs @ sp["wd"]).to(x.dtype)

    # load-balance auxiliary loss (Switch-style), first choices only
    me = torch.mean(F.one_hot(experts[:, 0], e.n_experts).float(), dim=0)
    ce = torch.mean(gates, dim=0)
    aux = e.n_experts * torch.sum(me * ce)
    return out, aux


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


def mamba_block(cfg: ModelConfig, p, x, *, cache=None):
    """Mamba-2 block. cache: dict(conv_x/conv_b/conv_c states, ssm state
    (B, H, N, P)).  Without a cache the chunked SSD runs through
    ``ops.ssd`` (the kernel under ``attn_impl="cuda"``); with one, the
    per-token recurrence.  Returns (x, new_cache_or_None)."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    h, pdim, n = cfg.n_ssm_heads, s_cfg.head_dim, s_cfg.d_state
    g = s_cfg.n_groups
    y = apply_norm(cfg, p["ln"], x)
    z = y @ p["wz"]
    xs = y @ p["wx"]
    bs = y @ p["wb"]
    cs = y @ p["wc"]
    dt = F.softplus((y @ p["wdt"]).float() + p["dt_bias"].float())  # (B,S,H)
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

    if cache is None:
        yh = kops.ssd(xh, dth, a, bh, ch, chunk=s_cfg.chunk,
                      impl=cfg.attn_impl)
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
            state = da[:, :, t, None, None] * state + dbx
            ys.append(torch.einsum("bhnp,bhn->bhp", state, chh[:, :, t]))
        yh = torch.stack(ys, dim=2)                             # (B,H,S,P)
        new_cache = {"conv_x": cx, "conv_b": cb, "conv_c": cc, "ssm": state}

    yh = yh.float() + p["d_skip"].float()[None, :, None, None] * xh.float()
    yflat = yh.transpose(1, 2).reshape(b, s, h * pdim)
    # gated RMSNorm (Mamba-2), in float32
    inv = torch.rsqrt(torch.mean(yflat * yflat, -1, keepdim=True) + 1e-6)
    yflat = yflat * inv * p["gate_norm"].float()
    yflat = yflat * F.silu(z.float())
    x = x + (yflat @ p["wo"].float()).to(x.dtype)
    return x, new_cache
