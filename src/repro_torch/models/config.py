"""Model configuration — one dataclass drives the whole zoo (the port of
``repro.models.config``).

A model is a stack of *stages*; each stage is a repeated unit of layer
kinds, e.g. ``((("attn",), 28),)`` for a plain decoder or
``((("mamba", "mamba", "mamba", "mamba", "mamba", "hybrid"), 6),
   (("mamba",), 2))`` for Zamba-2.  The forward loops over each unit's
repeats.

``attn_impl`` picks the kernels' route: ``"cuda"`` (the default; the
hand-written kernels, the reference's ``"pallas"``), ``"torch"`` (the
plain route, the reference's ``"xla"``) or ``"seq_shard"`` (the plain
route, with every one-row query sent to the distribution layer's
``dist.decode_attn.seq_sharded_attention``, which shards the cache's
sequence over the ambient mesh's ``model`` axis).  ``act_shard`` and
``fsdp_gather_dtype`` steer the reference's GSPMD layout hints: on
DTensors under a live mesh (the dry run) ``layers.constrain_btd`` lays
the activations out by ``act_shard`` and ``model.params_for_compute``
casts before or after the FSDP gather by ``fsdp_gather_dtype``; on plain
tensors they change nothing.

Layer kinds:
    attn    — self-attention (GQA / optional sliding window) + MLP
    moe     — self-attention + mixture-of-experts MLP
    cross   — self-attention + cross-attention (encoder / image memory) + MLP
    mamba   — Mamba-2 SSD block (attention-free)
    hybrid  — Mamba-2 block + *shared* attention block (Zamba-2 style; one
              parameter set reused at every hybrid position)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

LayerUnit = tuple[str, ...]
Stage = tuple[LayerUnit, int]

KINDS = ("attn", "moe", "cross", "mamba", "hybrid")
ATTN_IMPLS = ("torch", "cuda", "seq_shard")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128
    dt_min: float = 1e-3
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    stages: tuple[Stage, ...]
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper): encoder is a bidirectional attn stack over
    # stub frame embeddings provided by input_specs()
    encoder_layers: int = 0
    encoder_seq: int = 0
    # VLM (llama-3.2-vision): stub image-patch embeddings, cross-attended
    n_img_tokens: int = 0
    tie_embeddings: bool = False
    max_seq: int = 8192
    attn_impl: str = "cuda"          # cuda | torch | seq_shard (decode)
    act_shard: str = "model_d"       # layout hint (DTensors only)
    fsdp_gather_dtype: str = "f32"   # layout hint (DTensors only)
    remat: bool = True
    # loss
    loss_seq_chunk: int = 1024       # CE computed in sequence chunks
    logit_softcap: Optional[float] = None

    def __post_init__(self):
        assert (self.n_heads % max(self.n_kv_heads, 1) == 0
                or self.family == "ssm")
        n = sum(len(unit) * reps for unit, reps in self.stages)
        assert n == self.n_layers, \
            f"{self.name}: stages cover {n} layers, expected {self.n_layers}"
        for unit, _ in self.stages:
            for k in unit:
                assert k in KINDS, k
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{self.attn_impl!r}")

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    # ---- analytic parameter / FLOP accounting (roofline §Roofline) --------
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        n = 0
        n += self.vocab * d                       # embedding
        if not self.tie_embeddings:
            n += self.vocab * d                   # unembedding
        per_kind = {}
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        mlp = (3 if self.act == "swiglu" else 2) * d * self.d_ff
        per_kind["attn"] = attn + mlp + 2 * d
        if self.moe:
            e = self.moe
            moe_mlp = e.n_experts * 3 * d * e.d_ff_expert + d * e.n_experts
            if e.shared_expert:
                moe_mlp += 3 * d * e.d_ff_expert
            per_kind["moe"] = attn + moe_mlp + 2 * d
        if self.ssm:
            s = self.ssm
            di, g, ns = self.d_inner, s.n_groups, s.d_state
            h = self.n_ssm_heads
            in_proj = d * (2 * di + 2 * g * ns + h)
            conv = (di + 2 * g * ns) * s.conv_width
            extras = 2 * h + di  # A_log, dt_bias, D
            out = di * d
            per_kind["mamba"] = in_proj + conv + extras + out + di + d
        per_kind["hybrid"] = per_kind.get("mamba", 0)  # + shared attn once
        per_kind["cross"] = per_kind.get("attn", 0) + attn + d
        total_shared_attn = 0
        for unit, reps in self.stages:
            for k in unit:
                n += per_kind[k] * reps
            if "hybrid" in unit and total_shared_attn == 0:
                total_shared_attn = per_kind.get("attn", attn + mlp + 2 * d)
        n += total_shared_attn                     # zamba shared block (once)
        if self.encoder_layers:
            n += self.encoder_layers * (attn + mlp + 2 * d)
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared experts)."""
        if not self.moe:
            return self.param_count()
        e = self.moe
        inactive_experts = e.n_experts - e.top_k
        n_moe_layers = sum(unit.count("moe") * reps
                           for unit, reps in self.stages)
        return self.param_count() - \
            n_moe_layers * inactive_experts * 3 * self.d_model * e.d_ff_expert

    def model_flops_per_token(self, train: bool = True) -> float:
        """MODEL_FLOPS convention: 6*N_active (train) or 2*N_active (fwd)."""
        return (6.0 if train else 2.0) * self.active_param_count()


def smoke_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    hd = 16
    small = dict(
        n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=max(1, min(2, cfg.n_kv_heads)),
        d_ff=128, vocab=256, head_dim=hd, max_seq=128, loss_seq_chunk=32,
    )
    if cfg.moe:
        small["moe"] = MoEConfig(
            n_experts=4, top_k=cfg.moe.top_k, d_ff_expert=64,
            shared_expert=cfg.moe.shared_expert)
    if cfg.ssm:
        small["ssm"] = SSMConfig(d_state=16, expand=2, head_dim=16,
                                 n_groups=1, conv_width=4, chunk=16)
    # shrink stages to one unit containing every distinct layer kind the
    # full config uses (order-preserving) so smoke tests exercise them all
    kinds_seen: list[str] = []
    for unit, _reps in cfg.stages:
        for k in unit:
            if k not in kinds_seen:
                kinds_seen.append(k)
    if len(kinds_seen) == 1:
        small["stages"] = ((tuple(kinds_seen), 2),)
        small["n_layers"] = 2
    else:
        small["stages"] = ((tuple(kinds_seen), 1),)
        small["n_layers"] = len(kinds_seen)
    if cfg.encoder_layers:
        small["encoder_layers"] = 2
        small["encoder_seq"] = 32
    if cfg.n_img_tokens:
        small["n_img_tokens"] = 16
    if cfg.sliding_window:
        small["sliding_window"] = 32
    small["name"] = cfg.name + "-smoke"
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
