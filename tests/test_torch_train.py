"""The port's training path at smoke size vs the reference: the gradient
of ``loss_fn``, AdamW and its schedule, and ``make_train_step``.

The same numpy weights (``convert.init_numpy``) and batches go through
both packages: the reference's ``jax.value_and_grad`` of its ``loss_fn``
(``attn_impl="xla"``), the port's autograd on its plain route
(``attn_impl="torch"``).  The port keeps a stage's repeats as a list, the
reference on a leading axis, so gradients, moments and parameters cross
through ``convert.to_reference`` before they are compared leaf by leaf.

Tolerances, each with its reason:
* gradients, float32 compute (``COMPUTE_DTYPE`` set to float32 in both):
  each leaf within 1e-4 of its own largest magnitude; summation order
  only (measured under 1e-6).
* AdamW on the same gradients: 2e-6 relative and 1e-9 absolute, float32
  rounding (XLA and torch may round sqrt, pow and the divisions
  differently by an ulp); the schedule to 1e-6 relative.
* the train step with two microbatches, float32 compute, Adam's eps at
  1e-3 (see the test): parameters within 1e-6 absolute, loss and grad
  norm within 1e-5 relative.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.launch import steps as r_steps
from repro.models import config as r_config
from repro.models import model as r_model
from repro.optim import adamw as r_adamw
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import convert
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.optim import adamw as t_adamw

torch.set_num_threads(2)
ARCHS = ["qwen2-7b", "mamba2-1.3b", "whisper-small"]
# the same with the embedding tied (``unembed`` = ``embed``.T), a route
# that no published configuration takes but both packages keep
TIED = "qwen2-7b+tied"
_SETUPS: dict = {}


def setup_for(arch: str):
    """(reference config, port config, numpy tree) at smoke size; an
    ``arch`` ending in ``+tied`` ties the embedding."""
    if arch not in _SETUPS:
        name, _, tied = arch.partition("+")
        rcfg = r_config.smoke_config(r_configs.get(name),
                                     tie_embeddings=tied == "tied")
        tcfg = convert.config_from_reference(rcfg)
        _SETUPS[arch] = (rcfg, tcfg, convert.init_numpy(tcfg, seed=0))
    return _SETUPS[arch]


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(r_model, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_model, "COMPUTE_DTYPE", torch.float32)


def batch_for(cfg, b: int, s: int, seed: int):
    """A numpy batch: tokens, labels and, for whisper, float32 frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)),
           "labels": rng.integers(0, cfg.vocab, (b, s))}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if k in ("tokens", "labels")
                           else r_model.COMPUTE_DTYPE)
            for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) if k in ("tokens", "labels")
            else torch.from_numpy(v).to(t_model.COMPUTE_DTYPE)
            for k, v in batch.items()}


def leaves_close(got_tree, want_tree, rel: float, atol: float = 0.0):
    """Leaf by leaf: |got - want| <= rel * max|want| + atol."""
    flat_w, tdef_w = jax.tree.flatten(want_tree)
    flat_g, tdef_g = jax.tree.flatten(got_tree)
    assert tdef_w == tdef_g
    for w, g in zip(flat_w, flat_g):
        w = np.asarray(w, np.float32)
        g = np.asarray(g, np.float32)
        assert w.shape == g.shape
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * float(np.abs(w).max()) + atol)


def port_params(cfg, tree, requires_grad=False):
    params = convert.from_reference(cfg, tree, device="cpu")
    if requires_grad:
        t_layers.tree_map(lambda t: t.requires_grad_(True), params)
    return params


# ---------------------------------------------------------------------------
# the gradient of loss_fn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + [TIED])
def test_value_and_grad_match_jax(arch, f32):
    rcfg, tcfg, tree = setup_for(arch)
    batch = batch_for(tcfg, 2, 40, seed=1)
    (rloss, raux), rgrads = jax.value_and_grad(
        functools.partial(r_model.loss_fn, rcfg), has_aux=True)(
            jax.tree.map(jnp.asarray, tree), to_jax(batch))
    params = port_params(tcfg, tree, requires_grad=True)
    tloss, taux = t_model.loss_fn(tcfg, params, to_torch(batch))
    tloss.backward()
    tgrads = convert.to_reference(
        tcfg, t_layers.tree_map(lambda p: p.grad, params))
    assert float(tloss) == pytest.approx(float(rloss), rel=1e-5)
    assert float(taux["ce"]) == pytest.approx(float(raux["ce"]), rel=1e-5)
    leaves_close(tgrads, rgrads, rel=1e-4)
    # every leaf carries a gradient, the encoder's and the cross layers'
    assert all(float(np.abs(g).max()) > 0 for g in jax.tree.leaves(tgrads))


def test_remat_recomputes_the_same_gradients(f32):
    """``cfg.remat`` (torch.utils.checkpoint per unit, the encoder's too,
    and the loss's vocab chunks recomputed) changes no gradient."""
    _, tcfg, tree = setup_for("whisper-small")
    batch = to_torch(batch_for(tcfg, 2, 24, seed=2))
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        params = port_params(cfg, tree, requires_grad=True)
        t_model.loss_fn(cfg, params, batch)[0].backward()
        grads.append(t_layers.tree_leaves(
            t_layers.tree_map(lambda p: p.grad, params)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_scoring_without_grad_builds_no_graph():
    """Parameters that do not require grad give a loss with no graph;
    with them, the graph reaches every leaf."""
    _, tcfg, tree = setup_for("qwen2-7b")
    batch = to_torch(batch_for(tcfg, 1, 16, seed=3))
    loss, _ = t_model.loss_fn(tcfg, port_params(tcfg, tree), batch)
    assert loss.grad_fn is None and not loss.requires_grad
    params = port_params(tcfg, tree, requires_grad=True)
    loss, _ = t_model.loss_fn(tcfg, params, batch)
    assert loss.requires_grad
    grads = torch.autograd.grad(loss, t_layers.tree_leaves(params))
    assert all(g is not None for g in grads)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def test_cosine_schedule_matches_reference():
    for ocfg in (t_adamw.AdamWConfig(),
                 t_adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6),
                 t_adamw.AdamWConfig(warmup_steps=0, total_steps=1)):
        rcfg = r_adamw.AdamWConfig(**dataclasses.asdict(ocfg))
        for step in (0, 1, 2, 3, 5, 6, 50, 100, 101, 5000, 10_000, 20_000):
            got = t_adamw.cosine_schedule(ocfg, step)
            want = r_adamw.cosine_schedule(rcfg, step)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(want), rel=1e-6,
                                               abs=1e-12)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-small"])
def test_adamw_update_matches_reference(arch):
    """Two updates from a fresh state with random gradients: parameters,
    both moments, the step, the grad norm and the learning rate, leaf by
    leaf.  Decay follows the reference's layout, where a stage's norms
    are (repeats, d) matrices."""
    _, tcfg, tree = setup_for(arch)
    rng = np.random.default_rng(4)
    ocfg = t_adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                               clip_norm=0.5)
    rcfg = r_adamw.AdamWConfig(**dataclasses.asdict(ocfg))
    rp, tp = jax.tree.map(jnp.asarray, tree), port_params(tcfg, tree)
    rs, ts = r_adamw.adamw_init(rp), t_adamw.adamw_init(tp)
    r_update = jax.jit(functools.partial(r_adamw.adamw_update, rcfg))
    for _ in range(2):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), tree)
        rp, rs, rm = r_update(rp, jax.tree.map(jnp.asarray, g), rs)
        tp, ts, tm = t_adamw.adamw_update(
            ocfg, tp, convert.from_reference(tcfg, g, device="cpu"), ts)
        for name in ("grad_norm", "lr"):
            assert float(tm[name]) == pytest.approx(float(rm[name]),
                                                    rel=2e-6)
        leaves_close(convert.to_reference(tcfg, tp), rp, rel=2e-6,
                     atol=1e-9)
        for k in ("m", "v"):
            assert all(t.dtype == torch.float32
                       for t in t_layers.tree_leaves(ts[k]))
            leaves_close(convert.to_reference(tcfg, ts[k]), rs[k], rel=2e-6,
                         atol=1e-12)
        assert int(ts["step"]) == int(rs["step"])


def test_adamw_decays_by_the_reference_layout():
    """With zero gradients only the decay moves a parameter: a stage's norm
    scale ((repeats, d) in the reference) decays, the top-level final norm
    ((d,)) does not, and a matrix does."""
    _, tcfg, tree = setup_for("qwen2-7b")
    params = port_params(tcfg, tree)
    ocfg = t_adamw.AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5)
    zeros = t_layers.tree_map(torch.zeros_like, params)
    new, _, _ = t_adamw.adamw_update(ocfg, params, zeros,
                                     t_adamw.adamw_init(params))
    lr = float(t_adamw.cosine_schedule(ocfg, 1))
    for get in (lambda t: t["stages"][0][1]["0"]["attn"]["ln"]["scale"],
                lambda t: t["embed"]):
        torch.testing.assert_close(get(new), get(params) * (1 - lr * 0.5))
    assert torch.equal(new["final_norm"]["scale"],
                       params["final_norm"]["scale"])


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------
def test_train_step_with_two_microbatches_matches_reference(f32):
    """One step over 4 rows in two microbatches.  Adam's eps is 1e-3 here:
    at the default 1e-8 a first step moves each parameter by lr * g / |g|,
    which for a gradient entry near zero turns the 1e-6 summation-order
    differences into differences of up to lr itself."""
    rcfg, tcfg, tree = setup_for("mamba2-1.3b")
    ocfg = t_adamw.AdamWConfig(lr=1e-3, eps=1e-3, warmup_steps=0,
                               total_steps=10)
    rocfg = r_adamw.AdamWConfig(**dataclasses.asdict(ocfg))
    batch = batch_for(tcfg, 4, 32, seed=5)
    rp = jax.tree.map(jnp.asarray, tree)
    rp, _, rmet = jax.jit(r_steps.make_train_step(rcfg, rocfg,
                                                  accum_steps=2))(
        rp, r_adamw.adamw_init(rp), to_jax(batch))
    tp = port_params(tcfg, tree)
    step = t_steps.make_train_step(tcfg, ocfg, accum_steps=2)
    tp, ts, tmet = step(tp, t_adamw.adamw_init(tp), to_torch(batch))
    for name in ("loss", "ce", "grad_norm", "lr"):
        assert float(tmet[name]) == pytest.approx(float(rmet[name]),
                                                  rel=1e-5), name
    assert float(tmet["aux"]) == float(rmet["aux"]) == 0.0
    leaves_close(convert.to_reference(tcfg, tp), rp, rel=0.0, atol=1e-6)
    assert int(ts["step"]) == 1
    assert not any(p.requires_grad for p in t_layers.tree_leaves(tp))


def test_train_step_takes_the_plain_route_only():
    _, tcfg, _ = setup_for("qwen2-7b")
    with pytest.raises(ValueError, match="attn_impl='torch'"):
        t_steps.make_train_step(dataclasses.replace(tcfg, attn_impl="cuda"),
                                t_adamw.AdamWConfig())


def test_accum_for_matches_reference():
    @dataclasses.dataclass
    class Cell:
        kind: str
    for arch in r_configs.all_archs():
        for kind in ("train", "prefill"):
            assert t_steps.accum_for(
                convert.config_from_reference(r_configs.get(arch)),
                Cell(kind)) == r_steps.accum_for(r_configs.get(arch),
                                                 Cell(kind))


def test_train_cli_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``: the smoke
    mamba2-1.3b trains, checkpoints and finishes with finite losses."""
    out = t_train.main(["--device", "cpu", "--steps", "4", "--batch", "2",
                        "--seq", "32", "--ckpt-every", "2",
                        "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 4 and out["restarts"] == 0
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in out["metrics"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_00000002", "step_00000004"]
