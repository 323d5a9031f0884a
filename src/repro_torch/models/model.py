"""Top-level model: parameter metas, forward, loss, prefill, decode (the
port of ``repro.models.model``).

The stack is organized in *stages* (repeated units of layer kinds, see
``config.py``); the forward loops over each stage's repeats, whose
parameters are a list with one unit dict per repeat.  Mixed precision as
in the reference: float32 master parameters, cast to ``COMPUTE_DTYPE``
(bfloat16) at use; norms, decays and the Mamba output path go back to
float32 inside their layers.  Inference only: nothing here builds an
autograd graph.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Any

COMPUTE_DTYPE = torch.bfloat16


def cast_for_compute(tree):
    """Mixed precision: float32 master params are cast to COMPUTE_DTYPE at
    use; small numerically sensitive leaves (norms, ssm decays) are cast
    back to float32 inside their layers."""
    return L.tree_map(
        lambda w: w.to(COMPUTE_DTYPE) if w.dtype == torch.float32 else w,
        tree)


def _check_device(cfg: ModelConfig, device) -> None:
    """``attn_impl="cuda"`` runs the hand-written kernels: it takes CUDA
    tensors and raises on any other device, never running the plain route
    in their place."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{cfg.name}: device {device} asks for a CUDA "
                           "device and none is available")
    if cfg.attn_impl == "cuda" and device.type != "cuda":
        raise ValueError(
            f"{cfg.name}: attn_impl='cuda' runs the CUDA kernels and needs "
            f"its tensors on a CUDA device, got {device}; use "
            "attn_impl='torch' for the plain route")


# ---------------------------------------------------------------------------
# Parameter metadata for the whole model
# ---------------------------------------------------------------------------
def _block_meta(cfg: ModelConfig, kind: str) -> dict:
    if kind == "attn":
        return {"attn": L.attn_meta(cfg), "mlp": L.mlp_meta(cfg)}
    if kind == "moe":
        return {"attn": L.attn_meta(cfg), "moe": L.moe_meta(cfg)}
    if kind in ("mamba", "hybrid"):
        return {"mamba": L.mamba_meta(cfg)}   # shared attn lives at top level
    raise NotImplementedError(f"layer kind {kind!r} is not ported yet: "
                              f"{L.UNPORTED}")


def _has_hybrid(cfg: ModelConfig) -> bool:
    return any("hybrid" in unit for unit, _ in cfg.stages)


def model_meta(cfg: ModelConfig) -> dict:
    if cfg.encoder_layers or cfg.n_img_tokens:
        raise NotImplementedError(f"{cfg.name}: encoders and image memory "
                                  f"are not ported yet: {L.UNPORTED}")
    d = cfg.d_model
    meta: dict = {
        "embed": L.ParamMeta((cfg.vocab, d), ("vocab", "embed"), scale=0.02),
        "final_norm": L.norm_meta(cfg),
        "stages": [],
    }
    if not cfg.tie_embeddings:
        meta["unembed"] = L.ParamMeta((d, cfg.vocab), ("embed", "vocab"))
    for unit, reps in cfg.stages:
        unit_meta = {str(i): _block_meta(cfg, k) for i, k in enumerate(unit)}
        meta["stages"].append(L.stack_metas(unit_meta, reps))
    if _has_hybrid(cfg):
        meta["shared_attn"] = {"attn": L.attn_meta(cfg),
                               "mlp": L.mlp_meta(cfg)}
    return meta


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> Params:
    """Random float32 parameters on ``device``, drawn from ``generator``
    (a fresh one seeded 0 if None) with the reference's distributions."""
    _check_device(cfg, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return L.materialize(model_meta(cfg), generator, device)


def abstract_params(cfg: ModelConfig) -> Params:
    return L.abstract(model_meta(cfg))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _block_forward(cfg: ModelConfig, kind: str, p, x, *, positions,
                   shared=None, cache=None, pos=None):
    """Returns (x, aux_loss or None, new_cache or None)."""
    aux = None
    new_cache: dict = {}
    if kind in ("attn", "moe"):
        c_self = cache.get("self") if cache else None
        x, nc = L.attn_block(cfg, p["attn"], x, causal=True,
                             window=cfg.sliding_window, positions=positions,
                             cache=c_self, pos=pos)
        if nc is not None:
            new_cache["self"] = nc
        if kind == "moe":
            x, aux = L.moe_block(cfg, p["moe"], x)
        else:
            x = L.apply_mlp(cfg, p["mlp"], x)
    elif kind in ("mamba", "hybrid"):
        c_m = cache.get("mamba") if cache else None
        x, nc = L.mamba_block(cfg, p["mamba"], x, cache=c_m)
        if nc is not None:
            new_cache["mamba"] = nc
        if kind == "hybrid":
            c_s = cache.get("shared") if cache else None
            x, ncs = L.attn_block(cfg, shared["attn"], x, causal=True,
                                  positions=positions, cache=c_s, pos=pos)
            x = L.apply_mlp(cfg, shared["mlp"], x)
            if ncs is not None:
                new_cache["shared"] = ncs
    else:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet: "
                                  f"{L.UNPORTED}")
    return x, aux, (new_cache if cache is not None else None)


def _run_stage(cfg: ModelConfig, unit: tuple[str, ...], stage_params, x, *,
               positions, shared=None, cache=None, pos=None):
    """Loop one stage over its repeats.  ``cache`` (if any) is a list with
    one unit cache per repeat; so are the returned new caches.  Returns
    (x, the stage's summed auxiliary loss, new caches)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = [] if cache is not None else None
    for r, p_unit in enumerate(stage_params):
        p_unit = cast_for_compute(p_unit)
        c_unit = cache[r] if cache is not None else None
        new_c = {}
        for i, kind in enumerate(unit):
            ci = c_unit[str(i)] if c_unit is not None else None
            x, a, nc = _block_forward(cfg, kind, p_unit[str(i)], x,
                                      positions=positions, shared=shared,
                                      cache=ci, pos=pos)
            if a is not None:
                aux = aux + a
            if nc is not None:
                new_c[str(i)] = nc
        if new_cache is not None:
            new_cache.append(new_c)
    return x, aux, new_cache


@torch.no_grad()
def forward(cfg: ModelConfig, params: Params, tokens, *, memory=None,
            frames=None, img_embeds=None, positions=None,
            caches=None, pos=None):
    """Token ids -> hidden states (pre-unembed).

    caches/pos: decode mode (caches mirror the stages' structure).
    Returns (hidden (B,S,d), aux_loss, new_caches, memory)."""
    if memory is not None or frames is not None or img_embeds is not None:
        raise NotImplementedError(f"cross-attention sources are not ported "
                                  f"yet: {L.UNPORTED}")
    _check_device(cfg, tokens.device)
    x = params["embed"][tokens].to(COMPUTE_DTYPE)
    if positions is None:
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
    shared = params.get("shared_attn")
    if shared is not None:
        shared = cast_for_compute(shared)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [] if caches is not None else None
    for si, (unit, _reps) in enumerate(cfg.stages):
        c = caches[si] if caches is not None else None
        x, aux, nc = _run_stage(cfg, unit, params["stages"][si], x,
                                positions=positions, shared=shared, cache=c,
                                pos=pos)
        aux_total = aux_total + aux
        if new_caches is not None:
            new_caches.append(nc)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return x, aux_total, new_caches, memory


@torch.no_grad()
def unembed(cfg: ModelConfig, params: Params, hidden):
    if cfg.tie_embeddings:
        logits = hidden @ params["embed"].to(hidden.dtype).T
    else:
        logits = hidden @ params["unembed"].to(hidden.dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# Loss (vocab-chunked cross entropy: never materializes (B,S,V) at once)
# ---------------------------------------------------------------------------
@torch.no_grad()
def loss_fn(cfg: ModelConfig, params: Params, batch) -> tuple:
    """Cross entropy over a vocab-chunked unembedding, combined with a
    running logsumexp (value only: the port has no backward yet).
    Returns (loss, {"ce": ce, "aux": aux})."""
    tokens = batch["tokens"]
    labels = batch["labels"]
    hidden, aux, _, _ = forward(
        cfg, params, tokens,
        frames=batch.get("frames"), img_embeds=batch.get("img_embeds"))
    b, s, _ = hidden.shape
    v = cfg.vocab
    vc = min(v, max(16384, -(-v // 16)))
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    dev = hidden.device
    m_run = torch.full((b, s), float("-inf"), dtype=torch.float32, device=dev)
    s_run = torch.zeros((b, s), dtype=torch.float32, device=dev)
    gold = torch.zeros((b, s), dtype=torch.float32, device=dev)
    off = 0
    while off < v:
        size = min(vc, v - off)
        logits = (hidden @ w[:, off:off + size].to(hidden.dtype)).float()
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        m_c = logits.max(dim=-1).values
        s_c = torch.exp(logits - m_c[..., None]).sum(dim=-1)
        in_range = (labels >= off) & (labels < off + size)
        idx = torch.clamp(labels - off, 0, size - 1)
        gold = gold + torch.where(
            in_range, torch.gather(logits, -1, idx[..., None])[..., 0], 0.0)
        m_new = torch.maximum(m_run, m_c)
        s_run = s_run * torch.exp(m_run - m_new) + s_c * torch.exp(m_c - m_new)
        m_run = m_new
        off += size
    logz = m_run + torch.log(s_run)
    ce = torch.mean(logz - gold)
    moe_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    loss = ce + moe_w * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
def stage_cache(cfg: ModelConfig, unit, reps: int, batch: int, max_seq: int,
                dtype=torch.bfloat16, device="cuda"):
    """Cache of one stage: a list with one unit cache per repeat, zeros on
    ``device`` (``"meta"`` for shapes alone)."""
    def arr(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    hkv, hd = cfg.n_kv_heads, cfg.hd

    def one_repeat():
        c_unit = {}
        for i, kind in enumerate(unit):
            c: dict = {}
            if kind in ("attn", "moe"):
                c["self"] = {"k": arr((batch, hkv, max_seq, hd)),
                             "v": arr((batch, hkv, max_seq, hd))}
            elif kind in ("mamba", "hybrid"):
                s = cfg.ssm
                gn = s.n_groups * s.d_state
                c["mamba"] = {
                    "conv_x": arr((batch, s.conv_width - 1, cfg.d_inner)),
                    "conv_b": arr((batch, s.conv_width - 1, gn)),
                    "conv_c": arr((batch, s.conv_width - 1, gn)),
                    "ssm": arr((batch, cfg.n_ssm_heads, s.d_state,
                                s.head_dim), torch.float32),
                }
                if kind == "hybrid":
                    c["shared"] = {"k": arr((batch, hkv, max_seq, hd)),
                                   "v": arr((batch, hkv, max_seq, hd))}
            else:
                raise NotImplementedError(
                    f"layer kind {kind!r} is not ported yet: {L.UNPORTED}")
            c_unit[str(i)] = c
        return c_unit

    return [one_repeat() for _ in range(reps)]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda"):
    """Cache tree mirroring the stage structure."""
    return [stage_cache(cfg, unit, reps, batch, max_seq, dtype, device)
            for unit, reps in cfg.stages]


def prefill(cfg: ModelConfig, params: Params, tokens, max_seq: int, *,
            frames=None, img_embeds=None):
    """Run the prompt through the model, filling fresh KV/SSM caches from
    position 0.  Returns (last-token logits, caches, memory)."""
    b, _ = tokens.shape
    caches = init_cache(cfg, b, max_seq, device=tokens.device)
    hidden, _, caches, memory = forward(
        cfg, params, tokens, frames=frames, img_embeds=img_embeds,
        caches=caches, pos=0)
    logits = unembed(cfg, params, hidden[:, -1:, :])
    return logits, caches, memory


def decode_step(cfg: ModelConfig, params: Params, caches, token, pos, *,
                memory=None):
    """One decode step. token: (B, 1) ids; pos: the current length (an
    int).  Returns (logits (B,1,V), new_caches)."""
    positions = torch.zeros(token.shape[-1], dtype=torch.long,
                            device=token.device) + pos
    hidden, _, caches, _ = forward(
        cfg, params, token, memory=memory, positions=positions,
        caches=caches, pos=pos)
    return unembed(cfg, params, hidden), caches
