"""Decode and training steps that own their buffers, as the reference's
``make_case`` donates them (``donate_argnums=(1,)`` for decode, ``(0, 1)``
for training): the owning decode step writes the new K/V rows and Mamba
states into the caches it is given and returns those tensors; the
in-place AdamW writes parameters and moments in place, bit-equal to the
functional form; and the dry run's census, which counts the peak above
the arguments, no longer counts the second copy.
"""
from __future__ import annotations

import contextlib
import dataclasses

import pytest
import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs
from repro_torch.dist import context
from repro_torch.launch import census, dryrun, shapes, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as M
from repro_torch.models.config import smoke_config
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import adamw

MESH = ((2, 2, 2), ("pod", "data", "model"))


def ptrs(tree) -> list[int]:
    from torch.distributed.tensor import DTensor
    return [(t.to_local() if isinstance(t, DTensor) else t)
            .untyped_storage().data_ptr() for t in tree_leaves(tree)]


def prefilled(arch: str):
    cfg = smoke_config(configs.get(arch), attn_impl="torch")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    logits, caches, _ = M.prefill(cfg, params, prompt, 32)
    return cfg, params, torch.argmax(logits[:, -1], -1)[:, None], caches


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-1.2b", "whisper-small"])
def test_owning_decode_step_writes_its_cache_in_place(arch):
    """The owning step returns the very tensors it was given, holding
    what the functional step returns in new ones; the functional step
    leaves its argument as it was."""
    cfg, params, nxt, caches = prefilled(arch)
    before = tree_map(torch.clone, caches)
    want_logits, want = M.decode_step(cfg, params, caches, nxt, 12)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(caches),
                                                 tree_leaves(before)))
    owned = tree_map(torch.clone, caches)
    given = ptrs(owned)
    step = steps.make_decode_step(cfg)
    logits, got = step(params, owned, nxt, 12)
    assert ptrs(got) == given
    assert all(a is b for a, b in zip(tree_leaves(got), tree_leaves(owned)))
    assert torch.equal(logits, want_logits)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))


def test_inplace_adamw_is_bit_equal_to_functional_over_three_steps():
    cfg = smoke_config(configs.get("zamba2-1.2b"), attn_impl="torch")
    gen = torch.Generator().manual_seed(2)
    params = M.init_params(cfg, gen, "cpu")
    params["embed"] = params["embed"].to(torch.bfloat16)
    ocfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    pf, sf = params, adamw.adamw_init(params)
    pd = tree_map(torch.clone, params)
    sd = adamw.adamw_init(pd)
    ids = [id(t) for t in tree_leaves((pd, sd))]
    for _ in range(3):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen)
                         .to(p.dtype), params)
        pf, sf, mf = adamw.adamw_update(ocfg, pf, grads, sf)
        pd, sd, md = adamw.adamw_update(ocfg, pd, grads, sd, donate=True)
        assert torch.equal(mf["lr"], md["lr"])
        assert torch.equal(mf["grad_norm"], md["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((pf, sf)),
                                                 tree_leaves((pd, sd))))
    assert [id(t) for t in tree_leaves((pd, sd))] == ids
    assert int(sd["step"]) == 3


@contextlib.contextmanager
def functional_steps():
    """``make_case``'s and ``make_train_step``'s steps in the functional
    form (what they were before they owned their arguments), for
    comparison."""
    real_update, real_decode = steps.adamw_update, M.decode_step
    steps.adamw_update = lambda *a, **k: real_update(
        *a, **{**k, "donate": False})
    M.decode_step = lambda *a, **k: real_decode(*a, **{**k, "donate": False})
    try:
        yield
    finally:
        steps.adamw_update, M.decode_step = real_update, real_decode


def test_train_step_owns_params_and_moments():
    """``make_train_step`` updates in place, bit-equal to the functional
    step, which leaves its arguments."""
    cfg = smoke_config(configs.get("mamba2-1.3b"), attn_impl="torch")
    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    seqs = torch.randint(0, cfg.vocab, (2, 17),
                         generator=torch.Generator().manual_seed(4))
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    ocfg = adamw.AdamWConfig(warmup_steps=1)
    kept = tree_map(torch.clone, params)
    with functional_steps():
        pf, sf, _ = steps.make_train_step(cfg, ocfg)(
            params, adamw.adamw_init(params), batch)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(kept)))
    opt = adamw.adamw_init(params)
    given = ptrs((params, opt))
    pd, sd, _ = steps.make_train_step(cfg, ocfg)(params, opt, batch)
    assert ptrs((pd, sd)) == given
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((pf, sf)),
                                                 tree_leaves((pd, sd))))


def smoke_cell(arch: str, shape: str, seq: int):
    cell = shapes.make_cell(arch, shape)
    return dataclasses.replace(cell, seq_len=seq,
                               global_batch=min(8, cell.global_batch))


def census_of(arch: str, shape: str, seq: int, donate: bool) -> dict:
    """The census of a smoke cell on the (2, 2, 2) fake mesh: temp, the
    bytes still allocated when the step has returned, and the donated
    arguments' local bytes."""
    cfg = smoke_config(configs.get(arch))
    cell = smoke_cell(arch, shape, seq)
    mesh = mesh_mod.make_fake_mesh(True, device="cpu", shape=MESH[0],
                                   axes=MESH[1])
    try:
        case = steps.make_case(cfg, cell, mesh, device="cpu")
        with (contextlib.nullcontext() if donate else functional_steps()), \
                case.mode, context.use_mesh(mesh), implicit_replication(), \
                census.Census() as c:
            out = case.fn(*case.args)
            left = c.live
            del out
        args = case.args
        donated = args[1] if cell.kind == "decode" \
            else (args[0], args[1]["m"], args[1]["v"])
        return {"temp": c.peak_bytes, "left": left,
                "donated": dryrun.local_bytes(donated)}
    finally:
        mesh_mod.destroy_fake_mesh()


def test_census_temp_falls_by_the_donated_cache():
    """Decode: the peak above the arguments falls by the cache's local
    bytes, the copy the functional step makes."""
    fn = census_of("qwen2-7b", "decode_32k", 64, donate=False)
    own = census_of("qwen2-7b", "decode_32k", 64, donate=True)
    assert fn["temp"] - own["temp"] >= own["donated"] > 0, (fn, own)
    assert fn["left"] - own["left"] >= own["donated"], (fn, own)


def test_census_train_step_leaves_no_second_copy():
    """Training: the functional step's new parameters and moments are
    still allocated when it returns, the owning step's are the
    arguments.  So the bytes left allocated fall by at least params + m +
    v, and the peak falls; by less than those bytes here, because this
    cell's peak is in the backward (activations, gathered weights and
    gradients), which both steps share."""
    fn = census_of("qwen2-7b", "train_4k", 8, donate=False)
    own = census_of("qwen2-7b", "train_4k", 8, donate=True)
    assert fn["left"] - own["left"] >= own["donated"] > 0, (fn, own)
    assert fn["temp"] > own["temp"], (fn, own)


def test_real_dtensor_decode_case_returns_argument_storage():
    """``make_case``'s decode step on real DTensors (a one-rank fake
    mesh, as ``chip_smoke.py`` phase 21(b) runs it) hands back caches
    whose local shards are the arguments'."""
    cfg = smoke_config(configs.get("qwen2-7b"))
    cell = smoke_cell("qwen2-7b", "decode_32k", 64)
    mesh = mesh_mod.make_fake_mesh(False, device="cpu", shape=(1, 1),
                                   axes=("data", "model"))
    try:
        case = steps.make_case(cfg, cell, mesh, device="cpu",
                               fill=steps.real_fill(
                                   torch.Generator().manual_seed(5)))
        given = ptrs(case.args[1])
        with contextlib.ExitStack() as stack:
            stack.enter_context(context.use_mesh(mesh))
            stack.enter_context(implicit_replication())
            _, caches = case.fn(*case.args)
        assert ptrs(caches) == given
    finally:
        mesh_mod.destroy_fake_mesh()
