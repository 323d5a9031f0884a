"""Top-level model: parameter metas, forward, loss, prefill, decode (the
port of ``repro.models.model``).

The stack is organized in *stages* (repeated units of layer kinds, see
``config.py``); the forward loops over each stage's repeats, whose
parameters are a list with one unit dict per repeat.  Mixed precision as
in the reference: float32 master parameters, cast to ``COMPUTE_DTYPE``
(bfloat16) at use; norms, decays and the Mamba output path go back to
float32 inside their layers.

``forward`` and ``loss_fn`` are differentiable on the plain route
(``attn_impl="torch"``; the kernels have no backward and raise on inputs
that require grad).  With ``cfg.remat`` each unit of a stage and of the
encoder runs under ``torch.utils.checkpoint`` when a gradient is being
taken, as the reference's ``jax.checkpoint`` wraps its scan body, and
the loss recomputes each vocab chunk's logits in the backward.  Scoring
with parameters that do not require grad builds no graph; ``prefill``
and ``decode_step`` run under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def params_for_compute(cfg: ModelConfig, tree):
    """``cast_for_compute`` of a parameter tree at its use.  On DTensors
    under a live mesh (the dry run's global program) each leaf is first
    gathered over the batch axes (the FSDP gather,
    ``sharding.gather_batch_axes``): in float32 and then cast, or, with
    ``cfg.fsdp_gather_dtype == "bf16"``, cast first so that the gather
    moves half the bytes (the reference casts its stage's parameters
    before the scan for that).  On plain tensors only the cast."""
    mesh = L._dtensor_mesh(L.tree_leaves(tree)[0]) if tree else None
    if mesh is None:
        return cast_for_compute(tree)
    from repro_torch.dist import sharding
    if cfg.fsdp_gather_dtype == "bf16":
        tree = cast_for_compute(tree)
    tree = L.tree_map(lambda w: sharding.gather_batch_axes(w, mesh), tree)
    return cast_for_compute(tree)


def gathered(w):
    """One parameter as it is used: gathered over the batch axes when it
    is a DTensor under a live mesh (see ``params_for_compute``)."""
    mesh = L._dtensor_mesh(w)
    if mesh is None:
        return w
    from repro_torch.dist import sharding
    return sharding.gather_batch_axes(w, mesh)


def _check_device(cfg: ModelConfig, where) -> None:
    """``attn_impl="cuda"`` runs the hand-written kernels: it takes CUDA
    tensors and raises on any other device, never running the plain route
    in their place.  ``where``: a device, or a tensor on it; a fake tensor
    (the dry run's) names a device that need not exist."""
    simulated = isinstance(where, torch.Tensor) and _is_fake(where)
    device = torch.device(where.device if isinstance(where, torch.Tensor)
                          else where)
    if device.type == "cuda" and not simulated \
            and not torch.cuda.is_available():
        raise RuntimeError(f"{cfg.name}: device {device} asks for a CUDA "
                           "device and none is available")
    if cfg.attn_impl == "cuda" and device.type != "cuda":
        raise ValueError(
            f"{cfg.name}: attn_impl='cuda' runs the CUDA kernels and needs "
            f"its tensors on a CUDA device, got {device}; use "
            "attn_impl='torch' for the plain route")


def _is_fake(t) -> bool:
    """Whether ``t`` (or a DTensor's local shard) is a fake tensor."""
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


# ---------------------------------------------------------------------------
# Parameter metadata for the whole model
# ---------------------------------------------------------------------------
def _block_meta(cfg: ModelConfig, kind: str) -> dict:
    if kind == "attn":
        return {"attn": L.attn_meta(cfg), "mlp": L.mlp_meta(cfg)}
    if kind == "moe":
        return {"attn": L.attn_meta(cfg), "moe": L.moe_meta(cfg)}
    if kind == "cross":
        return {"attn": L.attn_meta(cfg),
                "xattn": L.attn_meta(cfg, cross=True), "mlp": L.mlp_meta(cfg)}
    if kind in ("mamba", "hybrid"):
        return {"mamba": L.mamba_meta(cfg)}   # shared attn lives at top level
    raise ValueError(kind)


def _has_hybrid(cfg: ModelConfig) -> bool:
    return any("hybrid" in unit for unit, _ in cfg.stages)


def model_meta(cfg: ModelConfig) -> dict:
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
    if cfg.encoder_layers:
        enc_unit = {"0": {"attn": L.attn_meta(cfg), "mlp": L.mlp_meta(cfg)}}
        meta["encoder"] = {
            "pos": L.ParamMeta((cfg.encoder_seq, d), (None, "embed")),
            "stages": [L.stack_metas(enc_unit, cfg.encoder_layers)],
            "final_norm": L.norm_meta(cfg),
        }
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
                   memory=None, shared=None, cache=None, pos=None,
                   donate: bool = False):
    """Returns (x, aux_loss or None, new_cache or None); ``donate``: the
    caches are written in place (``decode_step``)."""
    aux = None
    new_cache: dict = {}
    if kind in ("attn", "moe", "cross"):
        c_self = cache.get("self") if cache else None
        x, nc = L.attn_block(cfg, p["attn"], x, causal=True,
                             window=cfg.sliding_window, positions=positions,
                             cache=c_self, pos=pos, donate=donate)
        if nc is not None:
            new_cache["self"] = nc
        if kind == "cross":
            c_x = cache.get("cross") if cache else None
            x, ncx = L.attn_block(cfg, p["xattn"], x, cross=True,
                                  memory=memory, cache=c_x, pos=pos)
            if ncx is not None:
                new_cache["cross"] = ncx
        if kind == "moe":
            x, aux = L.moe_block(cfg, p["moe"], x)
        else:
            x = L.apply_mlp(cfg, p["mlp"], x)
    elif kind in ("mamba", "hybrid"):
        c_m = cache.get("mamba") if cache else None
        x, nc = L.mamba_block(cfg, p["mamba"], x, cache=c_m,
                              fresh=c_m is not None and pos == 0
                              and x.shape[1] > 1, donate=donate)
        if nc is not None:
            new_cache["mamba"] = nc
        if kind == "hybrid":
            c_s = cache.get("shared") if cache else None
            x, ncs = L.attn_block(cfg, shared["attn"], x, causal=True,
                                  positions=positions, cache=c_s, pos=pos,
                                  donate=donate)
            x = L.apply_mlp(cfg, shared["mlp"], x)
            if ncs is not None:
                new_cache["shared"] = ncs
    else:
        raise ValueError(kind)
    return x, aux, (new_cache if cache is not None else None)


def _remat(cfg: ModelConfig, x, p_unit) -> bool:
    """Whether a unit runs under ``torch.utils.checkpoint``: with
    ``cfg.remat``, when a gradient is being taken through it."""
    return cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad
                               for t in L.tree_leaves(p_unit)))


def _run_stage(cfg: ModelConfig, unit: tuple[str, ...], stage_params, x, *,
               positions, memory=None, shared=None, cache=None, pos=None,
               donate: bool = False):
    """Loop one stage over its repeats.  ``cache`` (if any) is a list with
    one unit cache per repeat; so are the returned new caches.  Without a
    cache each repeat may run under ``torch.utils.checkpoint``
    (``_remat``), which keeps only the unit's input for the backward.
    Returns (x, the stage's summed auxiliary loss, new caches)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = [] if cache is not None else None

    def unit_fn(x, p_unit, c_unit):
        x = L.constrain_btd(cfg, x)
        p_unit = params_for_compute(cfg, p_unit)
        a_unit = torch.zeros((), dtype=torch.float32, device=x.device)
        new_c = {}
        for i, kind in enumerate(unit):
            ci = c_unit[str(i)] if c_unit is not None else None
            x, a, nc = _block_forward(cfg, kind, p_unit[str(i)], x,
                                      positions=positions, memory=memory,
                                      shared=shared, cache=ci, pos=pos,
                                      donate=donate)
            if a is not None:
                a_unit = a_unit + a
            if nc is not None:
                new_c[str(i)] = nc
        return x, a_unit, new_c

    for r, p_unit in enumerate(stage_params):
        if cache is None and _remat(cfg, x, p_unit):
            x, a, _ = checkpoint(unit_fn, x, p_unit, None,
                                 use_reentrant=False)
        else:
            x, a, new_c = unit_fn(x, p_unit,
                                  cache[r] if cache is not None else None)
            if new_cache is not None:
                new_cache.append(new_c)
        aux = aux + a
    return x, aux, new_cache


def _encode(cfg: ModelConfig, params: Params, frames):
    """Whisper-style encoder over stub frame embeddings (B, S_enc, d) in
    the compute dtype: frames plus learned positions, then a bidirectional
    attention stack with rope over the frame positions."""
    enc = params["encoder"]
    x = frames + gathered(enc["pos"])[None, :frames.shape[1], :].to(
        frames.dtype)
    positions = torch.arange(frames.shape[1], device=frames.device)

    def unit_fn(x, p_unit):
        p = params_for_compute(cfg, p_unit)["0"]
        x, _ = L.attn_block(cfg, p["attn"], x, causal=False,
                            positions=positions)
        return L.apply_mlp(cfg, p["mlp"], x)

    for p_unit in enc["stages"][0]:
        if _remat(cfg, x, p_unit):
            x = checkpoint(unit_fn, x, p_unit, use_reentrant=False)
        else:
            x = unit_fn(x, p_unit)
    return L.apply_norm(cfg, enc["final_norm"], x)


def _embed(table, tokens):
    """The tokens' rows of the embedding ``table`` (V, d), in the compute
    dtype.  Under a live mesh where the table's vocabulary splits over
    ``model`` (``sharding.vocab_split``), the vocab-parallel lookup
    (``sharding.embed_specs``): each rank looks up the tokens in its
    range of rows on its own slice, the others at row 0 and zeroed, and
    the result is a pending sum over ``model`` (exact: one rank adds each
    row, the rest zeros), so the backward scatters into the rank's slice
    only."""
    w = gathered(table)
    mesh = L._dtensor_mesh(w)
    from repro_torch.dist import sharding
    if mesh is None or not sharding.vocab_split(w, 0, mesh):
        return F.embedding(tokens, w).to(COMPUTE_DTYPE)
    t = sharding.embed_specs(mesh, tokens)
    rows = w.shape[0] // sharding.model_size(mesh)
    v0 = mesh.coordinate()["model"] * rows

    def body(tok, wl):
        local = tok - v0
        mine = (local >= 0) & (local < rows)
        x = F.embedding(torch.where(mine, local, 0), wl)
        return (torch.where(mine[..., None], x, 0).to(COMPUTE_DTYPE),)
    (x,) = sharding.local_region(
        mesh, body, [(tokens, t["tokens"]), (w, t["table"])], [t["out"]],
        partial=(t["partial"],))
    return x


def forward(cfg: ModelConfig, params: Params, tokens, *, memory=None,
            frames=None, img_embeds=None, positions=None,
            caches=None, pos=None, donate: bool = False):
    """Token ids -> hidden states (pre-unembed).

    memory/frames/img_embeds: cross-attention sources (encoder-decoder /
    VLM; frames and image embeddings in the compute dtype, as the
    reference's input specs give them).  caches/pos: decode mode (caches
    mirror the stages' structure; ``donate``: written in place, see
    ``decode_step``).  Returns (hidden (B,S,d), aux_loss, new_caches,
    memory)."""
    _check_device(cfg, tokens)
    if frames is not None:
        memory = _encode(cfg, params, frames)
    if img_embeds is not None:
        memory = img_embeds
    x = L.constrain_btd(cfg, _embed(params["embed"], tokens))
    if positions is None:
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
    shared = params.get("shared_attn")
    if shared is not None:
        shared = params_for_compute(cfg, shared)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [] if caches is not None else None
    for si, (unit, _reps) in enumerate(cfg.stages):
        c = caches[si] if caches is not None else None
        x, aux, nc = _run_stage(cfg, unit, params["stages"][si], x,
                                positions=positions, memory=memory,
                                shared=shared, cache=c, pos=pos,
                                donate=donate)
        aux_total = aux_total + aux
        if new_caches is not None:
            new_caches.append(nc)
    x = L.constrain_btd(cfg, x)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return x, aux_total, new_caches, memory


def unembed(cfg: ModelConfig, params: Params, hidden):
    if cfg.tie_embeddings:
        logits = hidden @ gathered(params["embed"]).to(hidden.dtype).T
    else:
        logits = hidden @ gathered(params["unembed"]).to(hidden.dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# Loss (vocab-chunked cross entropy: never materializes (B,S,V) at once)
# ---------------------------------------------------------------------------
def _chunk_stats(cfg: ModelConfig, hidden, wc, labels, off: int):
    """One vocab chunk's (max, sum of exp at the max, gold logit) per
    position, from its (B, S, Vc) float32 logits."""
    logits = (hidden @ wc.to(hidden.dtype)).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    size = logits.shape[-1]
    m_c = logits.max(dim=-1).values
    s_c = torch.exp(logits - m_c[..., None]).sum(dim=-1)
    in_range = (labels >= off) & (labels < off + size)
    idx = torch.clamp(labels - off, 0, size - 1)
    gold_c = torch.where(
        in_range, torch.gather(logits, -1, idx[..., None])[..., 0], 0.0)
    return m_c, s_c, gold_c


def _vocab_chunk(cfg: ModelConfig) -> int:
    """Columns of the unembedding per loss chunk (the reference's rule)."""
    v = cfg.vocab
    return min(v, max(16384, -(-v // 16)))


def _running_stats(cfg: ModelConfig, hidden, w, labels, off: int,
                   chunk: int, stats=_chunk_stats):
    """(max, sum of exp at the max, gold logit) per position over the
    columns of ``w`` (vocabulary ids ``off`` on), ``chunk`` columns at a
    time combined with a running logsumexp.  When a gradient is taken
    each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``)."""
    b, s = labels.shape
    dev = hidden.device
    m_run = torch.full((b, s), float("-inf"), dtype=torch.float32, device=dev)
    s_run = torch.zeros((b, s), dtype=torch.float32, device=dev)
    gold = torch.zeros((b, s), dtype=torch.float32, device=dev)
    grad = torch.is_grad_enabled() and (hidden.requires_grad
                                        or w.requires_grad)
    v = w.shape[1]
    lo = 0
    while lo < v:
        size = min(chunk, v - lo)
        args = (cfg, hidden, w[:, lo:lo + size], labels, off + lo)
        m_c, s_c, gold_c = (checkpoint(stats, *args, use_reentrant=False)
                            if grad else stats(*args))
        gold = gold + gold_c
        m_new = torch.maximum(m_run, m_c)
        s_run = s_run * torch.exp(m_run - m_new) + s_c * torch.exp(m_c - m_new)
        m_run = m_new
        lo += size
    return m_run, s_run, gold


def _chunk_stats_sharded(cfg: ModelConfig, hidden, wc, labels, off: int):
    """``_chunk_stats`` on each rank's shards under a live mesh where the
    vocabulary is whole (``sharding.loss_specs``): the positions split
    over the batch axes and ``model``, the chunk's unembedding whole on
    every rank."""
    from repro_torch.dist import sharding
    mesh = L._dtensor_mesh(hidden)
    t = sharding.loss_specs(mesh, tuple(hidden.shape), False)
    return sharding.local_region(
        mesh, lambda h, w, y: _chunk_stats(cfg, h, w, y, off),
        [(hidden, t["hidden"]), (wc, t["w"]), (labels, t["labels"])],
        [t["out"]] * 3)


def _nll(cfg: ModelConfig, hidden, w, labels):
    """Per-position cross entropy, logsumexp minus the gold logit
    (float32), of ``hidden`` (B, S, d) against the columns of ``w`` (d, V),
    vocab-chunked: never (B, S, V) at once.  Under a live mesh where the
    vocabulary splits over ``model`` (``sharding.vocab_split``), the
    vocab-parallel loss (``_nll_vocab_parallel``); where it is whole,
    each chunk on each rank's positions (``_chunk_stats_sharded``)."""
    from repro_torch.dist import sharding
    mesh = L._dtensor_mesh(w)
    if mesh is not None and sharding.vocab_split(w, 1, mesh):
        return _nll_vocab_parallel(cfg, hidden, w, labels, mesh)
    if mesh is not None:
        # one gather of the unembedding in the compute dtype, which every
        # chunk slices (a slice of a DTensor split along it would gather
        # it whole, once per chunk, each kept for the backward)
        w = sharding.constrain(w.to(hidden.dtype), sharding.P(None, None),
                               mesh)
    stats = _chunk_stats_sharded if L._dtensor_mesh(hidden) is not None \
        else _chunk_stats
    m, s, gold = _running_stats(cfg, hidden, w, labels, 0, _vocab_chunk(cfg),
                                stats)
    return m + torch.log(s) - gold


def _nll_vocab_parallel(cfg: ModelConfig, hidden, w, labels, mesh):
    """``_nll`` with the vocabulary split over ``model``, in one local
    region (``sharding.loss_specs``): each rank its rows (the positions
    over the batch axes only, the hidden state gathered whole along the
    sequence) against its own slice of the columns, chunked over that
    slice into as many chunks as the whole vocabulary has, the
    statistics then combined over ``model`` (``_combine_over_vocab``).
    No rank holds the whole vocabulary, nor its gradient."""
    from repro_torch.dist import sharding
    t = sharding.loss_specs(mesh, tuple(hidden.shape), True)
    n = sharding.model_size(mesh)
    off = mesh.coordinate()["model"] * (w.shape[1] // n)

    def body(h, wl, y):
        m, s, gold = _running_stats(cfg, h, wl, y, off,
                                    -(-_vocab_chunk(cfg) // n))
        m, s, gold = _combine_over_vocab(m, s, gold, mesh.group(("model",)))
        return (m + torch.log(s) - gold,)
    (nll,) = sharding.local_region(
        mesh, body, [(hidden, t["hidden"]), (w, t["w"]),
                     (labels, t["labels"])], [t["out"]])
    return nll


def _combine_over_vocab(m, s, gold, group):
    """The statistics of each rank's slice of the vocabulary combined over
    ``group`` (the ``model`` ranks): the running max by an all-reduce MAX
    (detached: it only stabilises, and the logsumexp does not depend on
    it), the sums of exp rescaled to it and summed, the gold logits
    summed (only the rank whose slice holds the label adds one).  The
    sums go through ``psum_replicated``, whose backward hands each rank
    the replicated result's gradient, so the hidden state's gradient is
    a pending sum over ``group`` and the unembedding's stays on the
    rank's slice."""
    import torch.distributed as dist
    from repro_torch.dist import collectives
    m_all = m.detach().clone()
    dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
    s_all = collectives.psum_replicated(s * torch.exp(m - m_all), group)
    return m_all, s_all, collectives.psum_replicated(gold, group)


def loss_fn(cfg: ModelConfig, params: Params, batch) -> tuple:
    """Cross entropy over a vocab-chunked unembedding, combined with a
    running logsumexp (``_nll``): never materializes (B, S, V).  When a
    gradient is taken, each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` on
    ``chunk_stats``).  Returns (loss, {"ce": ce, "aux": aux})."""
    hidden, aux, _, _ = forward(
        cfg, params, batch["tokens"],
        frames=batch.get("frames"), img_embeds=batch.get("img_embeds"))
    w = gathered(params["embed"]).T if cfg.tie_embeddings \
        else gathered(params["unembed"])
    ce = torch.mean(_nll(cfg, hidden, w, batch["labels"]))
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
            if kind in ("attn", "moe", "cross"):
                c["self"] = {"k": arr((batch, hkv, max_seq, hd)),
                             "v": arr((batch, hkv, max_seq, hd))}
                if kind == "cross":
                    mem_len = cfg.encoder_seq or cfg.n_img_tokens
                    c["cross"] = {"k": arr((batch, hkv, mem_len, hd)),
                                  "v": arr((batch, hkv, mem_len, hd))}
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
                raise ValueError(kind)
            c_unit[str(i)] = c
        return c_unit

    return [one_repeat() for _ in range(reps)]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda"):
    """Cache tree mirroring the stage structure."""
    return [stage_cache(cfg, unit, reps, batch, max_seq, dtype, device)
            for unit, reps in cfg.stages]


def _placed_cache(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                  device):
    """Fresh caches as DTensors on ``cache_specs`` (sequence-sharded under
    ``attn_impl="seq_shard"``), each rank holding zeros of its shard: the
    reference's cache layout under its global program."""
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import sharding
    specs = sharding.cache_specs(cfg, mesh, batch, max_seq,
                                 seq_shard=cfg.attn_impl == "seq_shard")

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, sp) for v, sp in zip(tree, spec)]
        from repro_torch.launch.steps import local_shape
        local = torch.zeros(local_shape(tuple(tree.shape), spec, mesh),
                            dtype=tree.dtype, device=device)
        return DTensor.from_local(
            local, mesh.device_mesh,
            sharding.NamedSharding(mesh, spec).placements, run_check=False,
            shape=tree.shape, stride=tree.stride())

    return walk(init_cache(cfg, batch, max_seq, device="meta"), specs)


def _fresh_cache(cfg: ModelConfig, tokens, max_seq: int):
    """A prefill's fresh caches: DTensors on the mesh for DTensor tokens
    (``_placed_cache``); for plain tokens under a live mesh with
    ``attn_impl="seq_shard"``, each rank's chunks
    (``sharding.shard_cache``); else whole caches on the tokens'
    device."""
    b = tokens.shape[0]
    mesh = L._dtensor_mesh(tokens)
    if mesh is not None:
        return _placed_cache(cfg, mesh, b, max_seq, tokens.device)
    from repro_torch.dist import decode_attn
    mesh = decode_attn.seq_mesh() if cfg.attn_impl == "seq_shard" else None
    if mesh is None:
        return init_cache(cfg, b, max_seq, device=tokens.device)
    from repro_torch.dist import sharding
    return sharding.shard_cache(init_cache(cfg, b, max_seq, device="meta"),
                                mesh, device=tokens.device)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, tokens, max_seq: int, *,
            frames=None, img_embeds=None):
    """Run the prompt through the model, filling fresh KV/SSM caches from
    position 0 (and the cross caches from the encoder's or the image
    memory).  Returns (last-token logits, caches, memory)."""
    caches = _fresh_cache(cfg, tokens, max_seq)
    hidden, _, caches, memory = forward(
        cfg, params, tokens, frames=frames, img_embeds=img_embeds,
        caches=caches, pos=0)
    logits = unembed(cfg, params, hidden[:, -1:, :])
    return logits, caches, memory


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, caches, token, pos, *,
                memory=None, donate: bool = False):
    """One decode step. token: (B, 1) ids; pos: the current length (an
    int).  Cross layers attend over their cached memory K/V, or over
    ``memory`` projected anew when it is given.  Returns (logits (B,1,V),
    new_caches).

    By default the caller's caches are left as they were (the reference's
    functional step; ``ServeEngine`` keeps rows of the old cache).  With
    ``donate=True`` the step owns them, as the reference's decode case
    donates them (``launch.steps.make_decode_step``): the new K/V rows
    and Mamba states are written into the given tensors (a DTensor's
    local shards), and the returned caches hold those tensors, so no
    second copy is made.  A caller that keeps the old cache passes
    ``donate=False`` or a copy."""
    positions = torch.zeros(token.shape[-1], dtype=torch.long,
                            device=token.device) + pos
    hidden, _, caches, _ = forward(
        cfg, params, token, memory=memory, positions=positions,
        caches=caches, pos=pos, donate=donate)
    return unembed(cfg, params, hidden), caches
