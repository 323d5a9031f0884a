"""Logical-axis -> mesh-axis sharding rules (the port of
``repro.dist.sharding``; t5x-style, shape-checked).

Every parameter carries logical axis names in its ``ParamMeta``
(``models.layers``); this module turns them into specs (``P``) against a
mesh, and specs into DTensor placements.  The production meshes are
``("data", "model")`` and ``("pod", "data", "model")``:

* FSDP: the ``embed`` dimension of every weight shards over the batch axes
  (``pod`` x ``data``), ZeRO-3, since optimizer states mirror params.
* Tensor parallel: ``heads`` / ``kv_heads`` / ``ff`` / ``inner`` /
  ``experts`` / ``vocab`` shard over ``model`` (Megatron split; experts
  over ``model`` = expert parallelism).
* MoE ``expert_ff`` stays replicated.

**Divisibility fallback** (``fit_spec``): a mesh axis is only applied to a
tensor dimension when the dimension size divides evenly; otherwise the
axis is dropped (longest valid prefix for grouped axes) and the dimension
falls back toward replication.  A mesh axis is also never used twice in
one spec.  This is what keeps one rule set valid across the whole model
zoo: 6-head decode tensors on an 8-wide ``model`` axis simply replicate
(and the sequence dimension shards instead; see ``decode_attn``).

**Layout.**  The reference stacks a stage's repeats on a leading
``layers`` dimension (rule ``()``, so its entry is always None); the port
keeps the repeats as a list, so its spec for such a leaf is the
reference's without that leading entry.  The same holds for the caches'
leading ``reps`` dimension in ``cache_specs``.

**Placements.**  ``NamedSharding.placements`` gives one ``Shard(d)`` or
``Replicate()`` per mesh axis, for
``torch.distributed.tensor.distribute_tensor``.  A grouped entry
``("pod", "data")`` becomes ``Shard(d)`` on both axes, applied in mesh
order (the first outermost), which is JAX's major-to-minor split.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.dist import context

# logical axis -> candidate mesh axes (applied in order, longest valid
# prefix wins; see fit_spec)
DEFAULT_RULES: dict[Optional[str], tuple[str, ...]] = {
    "embed": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "inner": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_ff": (),
    "layers": (),
    None: (),
}


class P(tuple):
    """A partition spec: one entry per dimension, each None (replicated),
    a mesh axis name, or a tuple of names (split over all of them, the
    first outermost).  ``P(None, "model") == (None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _entry(axes: tuple[str, ...]):
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None -> ``()``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def fit_spec(spec, shape: tuple[int, ...], mesh) -> P:
    """Clamp ``spec`` to ``shape`` on ``mesh`` (divisibility fallback).

    Returns a full-rank spec (one entry per dimension).  Per dimension the
    requested mesh axes are applied left-to-right while the running
    product still divides the dimension size; axes that are absent from
    the mesh, already used by an earlier dimension, or break divisibility
    are dropped (dropping mid-group stops the group: a partial shard of
    a *later* axis alone would permute data, not restrict it).
    """
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used: set[str] = set()
    out = []
    for dim, entry in zip(shape, entries):
        kept: list[str] = []
        prod = 1
        for a in entry_axes(entry):
            if a not in mesh.axis_names or a in used:
                continue
            n = int(mesh.shape[a])
            if dim % (prod * n) != 0:
                break
            kept.append(a)
            prod *= n
        used.update(kept)
        out.append(_entry(tuple(kept)))
    return P(*out)


def spec_for_axes(axes: tuple[Optional[str], ...], mesh, *,
                  shape: Optional[tuple[int, ...]] = None,
                  rules: Optional[dict] = None) -> P:
    """Spec for one tensor from its logical axis names.

    With ``shape`` the spec is additionally clamped by ``fit_spec``;
    without it only mesh-membership and axis-reuse are enforced.
    """
    table = dict(DEFAULT_RULES)
    if rules:
        table.update(rules)
    raw = [tuple(table.get(name, ())) for name in axes]
    if shape is not None:
        return fit_spec(P(*[_entry(r) for r in raw]), tuple(shape), mesh)
    used: set[str] = set()
    out = []
    for r in raw:
        kept = tuple(a for a in r if a in mesh.axis_names and a not in used)
        used.update(kept)
        out.append(_entry(kept))
    return P(*out)


def batch_entry(mesh, b: int):
    """Spec entry for a batch of ``b``: the longest prefix of the batch
    axes whose product divides ``b``: ``("pod", "data")`` / ``"data"`` /
    ``None``."""
    kept: list[str] = []
    prod = 1
    for a in context.data_axes(mesh):
        n = int(mesh.shape[a])
        if b % (prod * n) != 0:
            break
        kept.append(a)
        prod *= n
    return _entry(tuple(kept))


def batch_axes(mesh):
    """The spec entry of the batch axes present in ``mesh``:
    ``("pod", "data")``, ``"data"`` or None."""
    return _entry(context.data_axes(mesh))


def batch_spec(mesh) -> P:
    """Spec for the leading (global batch) dimension: all batch axes
    grouped, e.g. ``P(("pod", "data"))``, or ``P()`` on a mesh with no
    batch axes (single-device fallback)."""
    baxes = context.data_axes(mesh)
    return P(_entry(baxes)) if baxes else P()


def local_rows(mesh, t, entry, dim: int = 0):
    """This rank's block of ``t`` along ``dim`` when that dimension is split
    over the axes of ``entry`` (all of ``t`` for None): the block at the
    rank's row-major position over those axes."""
    axes = entry_axes(entry)
    if not axes:
        return t
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    per = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axes) * per, per)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh axis (see the module
        docstring); raises on a grouped entry whose axes are out of mesh
        order, which has no such placement (the default rules make
        none)."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate() for _ in self.mesh.axis_names]
        for d, entry in enumerate(self.spec):
            axes = entry_axes(entry)
            pos = [self.mesh.axis_names.index(a) for a in axes]
            assert pos == sorted(pos), \
                f"entry {entry!r} is out of mesh order {self.mesh.axis_names}"
            for i in pos:
                out[i] = Shard(d)
        return tuple(out)


def place(x, sharding: NamedSharding):
    """``x`` (a tensor, an array, or a DTensor on another mesh) as a DTensor
    on ``sharding``'s live mesh and placements, each rank holding its
    local shard (``distribute_tensor``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return distribute_tensor(x, sharding.mesh.device_mesh,
                             sharding.placements)


def constrain(x, spec, mesh):
    """A DTensor ``x`` redistributed to ``spec`` (clamped by ``fit_spec``)
    on the live ``mesh``: the port's ``with_sharding_constraint``.
    DTensor inserts the collectives the change of layout needs."""
    target = NamedSharding(mesh, fit_spec(spec, tuple(x.shape), mesh))
    placements = target.placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh.device_mesh, placements)


def placements(spec, mesh, partial: tuple[str, ...] = ()) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (already fitted), with
    ``Partial()`` (a pending sum) on the mesh axes in ``partial``."""
    from torch.distributed.tensor import Partial
    out = list(NamedSharding(mesh, P(*spec)).placements)
    for a in partial:
        out[mesh.axis_names.index(a)] = Partial()
    return tuple(out)


def local_region(mesh, fn, inputs, out_specs, *, partial=()):
    """Run ``fn`` on each rank's local shards: the port's ``shard_map``
    inside the dry run's global program.  ``inputs`` is a list of
    ``(value, spec)``: a DTensor is redistributed to its spec (fitted)
    and handed to ``fn`` as its local shard; any other value (spec None)
    as it is.  ``fn`` returns a tuple of tensors, one per entry of
    ``out_specs`` (a spec, or None for a value that is not wrapped); each
    comes back a DTensor on its spec, with ``Partial()`` on the axes in
    ``partial`` (the entries of that tuple name, per output, its pending
    sums).  Differentiable: ``redistribute``, ``to_local`` and
    ``from_local`` all are; an input replicated over an axis that another
    input or an output splits takes its gradient as a pending sum over
    that axis (each rank's part of it)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    split = {a for _, spec in inputs if spec is not None
             for e in spec for a in entry_axes(e)}
    split |= {a for spec in out_specs if spec is not None
              for e in spec for a in entry_axes(e)}
    args = []
    for value, spec in inputs:
        if isinstance(value, DTensor):
            value = constrain(value, spec, mesh)
            # a replicated input read by shards split over an axis gets
            # its gradient as a pending sum over that axis
            grad = tuple(Partial() if isinstance(pl, Replicate) and a in split
                         else pl for a, pl in zip(mesh.axis_names,
                                                  value.placements))
            value = value.to_local(grad_placements=grad)
        args.append(value)
    outs = fn(*args)
    wrapped = []
    for i, (out, spec) in enumerate(zip(outs, out_specs)):
        if spec is None or not isinstance(out, torch.Tensor):
            wrapped.append(out)
            continue
        pend = partial[i] if partial else ()
        wrapped.append(DTensor.from_local(
            out, mesh.device_mesh, placements(spec, mesh, pend),
            run_check=False))
    return tuple(wrapped)


def gather_batch_axes(x, mesh):
    """The FSDP gather of a DTensor parameter: every placement on a batch
    axis (``pod``, ``data``) made ``Replicate``, the ``model`` axis kept
    (ZeRO-3: each layer's weights are gathered where they are used, and
    the gradient's way back is a reduce-scatter)."""
    from torch.distributed.tensor import Replicate, Shard
    batch = set(context.data_axes(mesh))
    placements = tuple(
        Replicate() if a in batch and isinstance(p, Shard) else p
        for a, p in zip(mesh.axis_names, x.placements))
    if placements == tuple(x.placements):
        return x
    return x.redistribute(mesh.device_mesh, placements)


def param_specs(cfg, mesh, rules: Optional[dict] = None) -> Any:
    """Spec tree mirroring ``models.model_meta(cfg)`` (a stage's repeats a
    list, each repeat's specs without the reference's leading entry)."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    return L.tree_map(lambda m: spec_for_axes(
        m.axes, mesh, shape=m.shape, rules=rules), M.model_meta(cfg))


def param_shardings(cfg, mesh, rules: Optional[dict] = None) -> Any:
    """``NamedSharding`` tree mirroring the parameter tree; each leaf's
    ``placements`` feed ``distribute_tensor``."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    return L.tree_map(lambda m: NamedSharding(mesh, spec_for_axes(
        m.axes, mesh, shape=m.shape, rules=rules)), M.model_meta(cfg))


# ---------------------------------------------------------------------------
# The blocks' spec tables: what each rank holds in a block's local region
# ---------------------------------------------------------------------------
# Under a live mesh the model runs each block on the ranks' shards
# (``local_region``, the reference's partitioner's choices made by hand).
# The tables below say, per block, which dimensions of its inputs and
# outputs split over which mesh axes; ``models.layers`` and
# ``models.model`` run the bodies.  A spec given with a shape is fitted
# (``fit_spec``); the others are fitted where they are used.
def model_size(mesh) -> int:
    """Ranks on the ``model`` axis (1 when the mesh has none)."""
    return int(mesh.shape["model"]) if "model" in mesh.axis_names else 1


def model_split(mesh, n: int):
    """``"model"`` when a dimension of ``n`` splits over more than one
    ``model`` rank, else None."""
    m = model_size(mesh)
    return "model" if m > 1 and n % m == 0 else None


def mlp_specs(cfg, mesh, shape, d_ff: Optional[int] = None) -> dict:
    """The MLP (``layers._mlp_sharded``; the MoE's shared expert with its
    ``d_ff``), Megatron-style: the hidden width over ``model`` where it
    divides (the first products' columns, the last one's rows), the
    output a pending sum over ``model``; the batch (the rows of ``shape``,
    the activations') over the batch axes."""
    fm = model_split(mesh, d_ff or cfg.d_ff)
    return {"rows": fit_spec(P(batch_axes(mesh), None, None), shape, mesh),
            "partial": ("model",) if fm else (),
            "weights": {"wg": P(None, fm), "wu": P(None, fm),
                        "wd": P(fm, None), "w1": P(None, fm), "b1": P(fm),
                        "w2": P(fm, None)}}


def attn_specs(cfg, mesh, seq: int, *, ring: bool) -> dict:
    """The attention block (``layers._attn_sharded``), in one of four
    modes over ``model`` (m ranks):

    * ``heads``: the query heads split over ``model`` where they divide
      (the K/V heads too where those divide, else each rank computes all
      and reads the ones its query heads share), the output projection's
      rows with them, so the block's output is a pending sum over
      ``model`` (the reduction the residual's layout resolves);
    * ``ring`` (``ring``: decode against a cache stored sharded by
      sequence, ``attn_impl="seq_shard"``): every rank the whole
      (one-row) projection, its own chunk of the cache, the chunks round
      the ring;
    * ``seq``: where the heads do not divide, the ``seq`` query rows
      split over ``model`` (each rank all K/V rows and heads, every key
      read under the mask, so every rank does the same work);
    * ``replicated``: neither divides (one-row decode): every rank the
      whole block.
    The batch splits over the batch axes throughout.  Returns the mode,
    the K/V heads' entry, the weights', queries', keys' and cache's
    specs and the output's pending sums."""
    m = model_size(mesh)
    b = batch_axes(mesh)
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if m == 1:
        mode = "replicated"
    elif ring:
        mode = "ring"
    elif hq % m == 0 and (hkv % m == 0 or m % hkv == 0):
        mode = "heads"
    elif seq % m == 0 and seq > 1:
        mode = "seq"
    else:
        mode = "replicated"
    heads = "model" if mode == "heads" else None
    kv = heads if hkv % m == 0 else None
    return {"mode": mode, "kv_split": kv,
            "weights": {"wq": P(None, heads, None), "bq": P(heads, None),
                        "wk": P(None, kv, None), "bk": P(kv, None),
                        "wv": P(None, kv, None), "bv": P(kv, None),
                        "wo": P(heads, None, None)},
            "q": P(b, "model" if mode == "seq" else None, None),
            "kv": P(b, None, None),
            "cache": P(b, kv, "model" if mode == "ring" else None, None),
            "partial": ("model",) if mode == "heads" else ()}


def moe_specs(cfg, mesh, shape) -> dict:
    """The MoE block (``layers._moe_sharded``): the experts over ``model``
    where they divide (expert parallelism; the routed output a pending
    sum over ``model``), the router whole on every rank, the batch (the
    rows of ``shape``) over the batch axes; the shared expert as an MLP
    of ``d_ff_expert`` (``mlp_specs``)."""
    em = model_split(mesh, cfg.moe.n_experts)
    return {"rows": fit_spec(P(batch_axes(mesh), None, None), shape, mesh),
            "experts": em, "router": P(None, None),
            "expert": P(em, None, None),
            "partial": ("model",) if em else (),
            "shared": mlp_specs(cfg, mesh, shape, cfg.moe.d_ff_expert)}


def mamba_specs(cfg, mesh) -> dict:
    """The Mamba block (``layers._mamba_sharded`` and
    ``_mamba_out_sharded``): batch over the batch axes, the heads (and
    ``d_inner`` with them) over ``model`` where they divide and there is
    one group of B and C (a rank's heads read their own group; every
    configuration of the zoo has one); B and C whole on every rank; the
    output projection's rows of ``d_inner`` split with the heads, its
    product a pending sum."""
    b = batch_axes(mesh)
    hm = model_split(mesh, cfg.n_ssm_heads) if cfg.ssm.n_groups == 1 \
        else None
    rows, inner = P(b, None, None), P(b, None, hm)
    col, whole, split = P(None, hm), P(None, None), P(hm)
    return {"rows": rows, "inner": inner,
            "weights": {"wz": col, "wx": col, "wb": whole, "wc": whole,
                        "wdt": col, "dt_bias": split,
                        "conv_x": P(hm, None), "conv_b": whole,
                        "conv_c": whole, "a_log": split, "d_skip": split},
            "cache": {"conv_x": inner, "conv_b": rows, "conv_c": rows,
                      "ssm": P(b, hm, None, None)},
            "wo": P(hm, None), "partial": ("model",) if hm else ()}


def vocab_split(x, dim: int, mesh) -> bool:
    """Whether the DTensor ``x``'s dimension ``dim`` (a vocabulary) is
    split over a ``model`` axis of more than one rank, as ``fit_spec``
    splits a vocabulary that divides: then the embedding and the loss
    run on each rank's slice of it (``embed_specs``, ``loss_specs``)."""
    from torch.distributed.tensor import Shard
    if model_size(mesh) == 1:
        return False
    pl = x.placements[mesh.axis_names.index("model")]
    return isinstance(pl, Shard) and pl.dim == dim


def embed_specs(mesh, tokens) -> dict:
    """The vocab-parallel embedding (``models.model._embed``): the table's
    rows (the vocabulary) over ``model``, each rank looking up the tokens
    of its range; the tokens (a DTensor's rows over the batch axes, a
    plain tensor whole) and the output alike, the output a pending sum
    over ``model``."""
    from torch.distributed.tensor import DTensor
    rows = fit_spec(P(batch_axes(mesh), None), tuple(tokens.shape), mesh) \
        if isinstance(tokens, DTensor) else None
    return {"tokens": rows, "table": P("model", None),
            "out": P(*(rows or (None, None)), None), "partial": ("model",)}


def loss_specs(mesh, shape, split: bool) -> dict:
    """The loss's region over the hidden states of ``shape`` (B, S, d)
    (``models.model._nll``).  ``split`` (``vocab_split``): each rank its
    slice of the unembedding's columns, the positions over the batch
    axes only, so the hidden state whole along the sequence (gathered
    over ``model``); the statistics combine over ``model``.  Else the
    unembedding whole on every rank, the positions over the batch axes
    and ``model``.  The labels and the per-position output split as the
    positions."""
    b = batch_axes(mesh)
    model = None if split or "model" not in mesh.axis_names else "model"
    rows = fit_spec(P(b, model, None), shape, mesh)
    return {"hidden": rows, "w": P(None, "model" if split else None),
            "labels": P(*rows[:2]), "out": P(*rows[:2])}


def cache_specs(cfg, mesh, batch: int, seq_len: int, *,
                seq_shard: bool = False) -> Any:
    """Spec tree mirroring ``models.init_cache`` (one unit cache per
    repeat, each spec without the reference's leading ``reps`` entry).

    KV caches (B, Hkv, S, hd) shard batch over the batch axes and, by
    default, heads over ``model``.  With ``seq_shard=True`` the cache
    *sequence* shards over ``model`` instead (the long-context decode
    layout consumed by ``decode_attn.seq_sharded_attention``).  Mamba
    states shard their channel/head dimension over ``model``.  Every spec
    passes through ``fit_spec``, so indivisible dims fall back to
    replication.
    """
    from repro_torch.models import model as M
    b = _entry(context.data_axes(mesh))

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        if name in ("k", "v"):
            spec = P(b, None, "model", None) if seq_shard \
                else P(b, "model", None, None)
        elif name == "ssm":
            spec = P(b, "model", None, None)
        elif name in ("conv_x", "conv_b", "conv_c"):
            spec = P(b, None, "model")
        else:
            spec = P(b)
        return fit_spec(spec, tuple(tree.shape), mesh)

    return walk(M.init_cache(cfg, batch, seq_len, device="meta"))


def shard_cache(caches, mesh, *, device=None) -> Any:
    """A cache tree of whole tensors (``models.init_cache``, a no-mesh
    prefill's caches) placed on the live ``mesh`` for a sequence-sharded
    decode on plain tensors, the counterpart of jit's ``in_shardings``:
    every self-attention K/V cache (B, Hkv, S, hd) becomes this rank's
    block of it under ``cache_specs(seq_shard=True)``, its batch rows
    over the batch axes and its chunk of the sequence over ``model`` (a
    new tensor; the whole one can be dropped).  The other caches (Mamba
    states, cross-attention K/V) stay whole: a plain-tensor model
    computes them whole on every rank.  A ``meta`` tree gives zeros on
    ``device``.  The sequence must divide by the ``model`` axis, so that
    every chunk is as long as every other (the decode step reads the
    whole length as n chunks)."""
    n = int(mesh.shape["model"]) if "model" in mesh.axis_names else 1

    def block(t):
        spec = fit_spec(P(_entry(context.data_axes(mesh)), None, "model",
                          None), tuple(t.shape), mesh)
        if n > 1 and spec[2] is None:
            raise ValueError(f"a cache of {t.shape[2]} rows does not split "
                             f"into {n} chunks over 'model'")
        if t.device.type == "meta":
            from repro_torch.launch.steps import local_shape
            return torch.zeros(local_shape(tuple(t.shape), spec, mesh),
                               dtype=t.dtype, device=device)
        for d, entry in enumerate(spec):
            t = local_rows(mesh, t, entry, dim=d)
        return t.to(device or t.device).clone()

    def walk(tree, attn: bool = False):
        if isinstance(tree, dict):
            return {k: walk(v, attn or k in ("self", "shared"))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if attn:
            return block(tree)
        if tree.device.type == "meta":
            return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
        return tree

    return walk(caches)
