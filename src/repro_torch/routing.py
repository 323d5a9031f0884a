"""Expert routing shared by the model zoo and the trace front ends: the
stable top-k (``jax.lax.top_k``'s ties), DeepSeek-V3's group-limited
router and LongCat-Flash's softmax router over real and zero-compute
experts.  Plain torch with no model or kernel import, so a trace front end
routes tokens without loading the zoo (whose kernel wrappers import
DTensor: ~6 s of a process's start on the card).  ``models.layers``
re-exports the first two."""
from __future__ import annotations

import torch


def top_k(gates, k: int):
    """The k largest gates per row and their expert ids, ties broken
    towards the lower id as ``jax.lax.top_k`` breaks them (a stable
    descending sort; ``torch.topk`` promises no order among equals)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def group_limited_top_k(logits, bias, *, n_group: int, topk_group: int,
                        k: int, scaling: float, norm: bool = True):
    """DeepSeek-V3's router (``scoring_func`` sigmoid, ``topk_method``
    noaux_tc) on router logits (T, E): the weights (T, k) float32 and the
    expert ids (T, k) of each token.

    Scores are sigmoid(logits); the choice adds the correction ``bias``
    (E,).  A group's score is the sum of its two largest choices; a token
    keeps its ``topk_group`` best of the ``n_group`` groups and takes the
    ``k`` largest choices of the kept groups (the others masked to 0, as
    the published code masks them).  The weights are the chosen scores,
    divided by their sum when ``norm``, times ``scaling``.  Ties go to the
    lower id, as ``top_k`` breaks them."""
    scores = torch.sigmoid(logits.float())
    choice = scores + bias.float()
    t, e = choice.shape
    group_score = top_k(choice.view(t, n_group, e // n_group),
                        2)[0].sum(dim=-1)                     # (T, G)
    _, groups = top_k(group_score, topk_group)
    kept = torch.zeros_like(group_score, dtype=torch.bool).scatter_(
        1, groups, True)
    kept = kept.repeat_interleave(e // n_group, dim=1)        # (T, E)
    _, experts = top_k(torch.where(kept, choice, 0.0), k)
    weights = scores.gather(1, experts)
    if norm:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return weights * scaling, experts


def softmax_top_k(logits, bias, *, k: int, scaling: float):
    """LongCat-Flash's router (a softmax over every output, zero-compute
    experts among them) on router logits (T, E): the weights (T, k)
    float64 and the output ids (T, k) of each token.

    Scores are softmax(logits) over all E outputs; the choice adds the
    expert ``bias`` (E,) and takes the ``k`` largest, ties to the lower id
    as ``top_k`` breaks them.  The weights are the chosen scores times
    ``scaling``, not renormalised.  The softmax and the choice run in
    float64, so two choices a rounding could swap lie within ~1e-16 of
    each other."""
    scores = torch.softmax(logits.double(), dim=-1)
    _, experts = top_k(scores + bias.double(), k)
    return scores.gather(1, experts) * scaling, experts
