"""The port's dense decoder-only architectures at smoke size vs the reference.

qwen2-7b, qwen2.5-14b (both with QKV bias), command-r-plus-104b and
h2o-danube-1.8b (sliding window) through ``smoke_config`` (d_model 64,
GQA 4/2, two ``attn`` layers; h2o-danube's window cut to 32): the same
numpy weights (``convert.init_numpy``, with the zero-initialised QKV
biases redrawn so that they matter) and numpy tokens go through both
packages, the reference with ``attn_impl="xla"`` and the port with
``attn_impl="torch"``, its plain route on the CPU.  The smoke configs of
qwen2-7b and qwen2.5-14b differ only in name; both stay cases of each
parametrised test.

Tolerances, each with its reason (those of ``tests/test_torch_models.py``):
* float32 compute (``COMPUTE_DTYPE`` set to float32 in both packages by
  ``monkeypatch``): 2e-4 absolute and relative on hidden states, logits,
  loss and decode logits: summation order only (measured under
  1e-6 on hidden states of magnitude 4).
* bfloat16 as shipped: hidden states 0.1 + 2e-2 relative, logits and loss
  2e-2: both packages round each layer's output to bfloat16 at different
  points inside fused ops (measured 0.031 on hidden states).
* the K/V cache, which stays bfloat16 under float32 compute: one bfloat16
  ulp (2**-7 relative), where float32 keys that differ in their last bits
  round to neighbours (measured: 1 of 4 096 entries).
* serving, float32 compute: per-step logits 2e-4, greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import config as r_config
from repro.models import model as r_model
from repro.serve import engine as r_engine
from repro_torch import configs as t_configs
from repro_torch.models import config as t_config
from repro_torch.models import convert
from repro_torch.models import model as t_model
from repro_torch.serve import engine as t_engine

torch.set_num_threads(2)
F32 = dict(atol=2e-4, rtol=2e-4)
KV = dict(atol=2e-4, rtol=2 ** -7)
ARCHS = ["qwen2-7b", "qwen2.5-14b", "command-r-plus-104b", "h2o-danube-1.8b"]
_SETUPS: dict = {}


def with_biases(tree, seed: int):
    """The tree with every QKV bias redrawn from a normal of scale 0.5 (the
    init draws zeros, which would leave the bias path untested)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (rng.standard_normal(v.shape).astype(np.float32)
                        * np.float32(0.5)
                        if k in ("bq", "bk", "bv") else walk(v))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(tree)


def setup_for(arch: str):
    """(reference config, port config, reference params, port params, numpy
    tree) at smoke size, built once per architecture."""
    if arch not in _SETUPS:
        rcfg = r_config.smoke_config(r_configs.get(arch))
        tcfg = convert.config_from_reference(rcfg)
        tree = with_biases(convert.init_numpy(tcfg, seed=0), seed=1)
        _SETUPS[arch] = (rcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                         convert.from_reference(tcfg, tree, device="cpu"),
                         tree)
    return _SETUPS[arch]


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(r_model, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_model, "COMPUTE_DTYPE", torch.float32)


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def close(got, want, **kw):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **kw)


def forward_both(arch: str, s: int, seed: int = 1):
    """Hidden states, logits and (loss, aux) of both packages over the same
    2 x s tokens and labels."""
    rcfg, tcfg, rparams, tparams, _ = setup_for(arch)
    tok = tokens((2, s), tcfg.vocab, seed=seed)
    lab = tokens((2, s), tcfg.vocab, seed=seed + 1)
    rh, *_ = r_model.forward(rcfg, rparams, jnp.asarray(tok, jnp.int32))
    th, *_ = t_model.forward(tcfg, tparams, torch.from_numpy(tok))
    rl = r_model.unembed(rcfg, rparams, rh)
    tl = t_model.unembed(tcfg, tparams, th)
    rloss, raux = r_model.loss_fn(rcfg, rparams, {
        "tokens": jnp.asarray(tok, jnp.int32),
        "labels": jnp.asarray(lab, jnp.int32)})
    tloss, taux = t_model.loss_fn(tcfg, tparams, {
        "tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})
    return (rh, rl, rloss, raux["aux"]), (th, tl, tloss, taux["aux"])


# ---------------------------------------------------------------------------
# configuration and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_parameter_count_equal_the_reference(arch):
    full_r, full_t = r_configs.get(arch), t_configs.get(arch)
    assert full_t.attn_impl == "cuda" and full_t.family == "dense"
    assert convert.config_from_reference(
        dataclasses.replace(full_r, attn_impl="pallas")) == full_t
    assert t_config.smoke_config(full_t, attn_impl="torch") == \
        convert.config_from_reference(r_config.smoke_config(full_r))
    # at full width, from shapes alone: the meta device and ShapeDtypeStructs
    n_t = sum(t.numel() for t in t_model.L.tree_leaves(
        t_model.abstract_params(full_t)))
    n_r = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        r_model.abstract_params(full_r)))
    assert n_t == n_r == full_t.param_count() == full_r.param_count()


def test_smoke_configs_of_the_two_qwens_differ_only_in_name():
    a, b = (t_config.smoke_config(t_configs.get(n))
            for n in ("qwen2-7b", "qwen2.5-14b"))
    assert a.qkv_bias and dataclasses.replace(b, name=a.name) == a


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_round_trip_with_reference_shapes(arch):
    rcfg, tcfg, _, tparams, tree = setup_for(arch)
    back = convert.to_reference(tcfg, tparams)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for x, y in zip(flat_a, flat_b):
        np.testing.assert_array_equal(x, y)
    abstract = r_model.abstract_params(rcfg)
    assert jax.tree.structure(abstract) == tdef_a
    for want, got in zip(jax.tree.leaves(abstract), flat_b):
        assert tuple(want.shape) == got.shape and got.dtype == np.float32
    attn = tparams["stages"][0][1]["0"]["attn"]
    assert ("bq" in attn) == tcfg.qkv_bias
    if tcfg.qkv_bias:
        want = tree["stages"][0]["0"]["attn"]["bk"][1]
        assert float(np.abs(want).max()) > 0.5
        np.testing.assert_array_equal(attn["bk"].numpy(), want)


# ---------------------------------------------------------------------------
# forward, unembed, loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_match_reference_float32(arch, f32):
    (rh, rl, rloss, raux), (th, tl, tloss, taux) = forward_both(arch, 40)
    assert th.dtype == torch.float32 and th.shape == (2, 40, 64)
    close(th, rh, **F32)
    close(tl, rl, **F32)
    assert float(tloss) == pytest.approx(float(rloss), rel=2e-4, abs=2e-4)
    assert float(taux) == float(raux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_match_reference_bfloat16(arch):
    (rh, rl, rloss, _), (th, tl, tloss, _) = forward_both(arch, 64, seed=3)
    assert th.dtype == torch.bfloat16
    close(th, rh, atol=0.1, rtol=2e-2)
    close(tl, rl, atol=2e-2, rtol=2e-2)
    assert float(tloss) == pytest.approx(float(rloss), abs=2e-2)
    assert float(tloss) == pytest.approx(np.log(256), rel=0.15)


def test_sliding_window_binds_and_matches_reference(f32):
    """h2o-danube's smoke window of 32 at 64 tokens: the second half of the
    sequence sees less than its causal prefix, and both packages agree;
    without the window the port's hidden states move."""
    rcfg, tcfg, rparams, tparams, _ = setup_for("h2o-danube-1.8b")
    assert tcfg.sliding_window == 32
    tok = tokens((2, 64), tcfg.vocab, seed=7)
    rh, *_ = r_model.forward(rcfg, rparams, jnp.asarray(tok, jnp.int32))
    th, *_ = t_model.forward(tcfg, tparams, torch.from_numpy(tok))
    close(th, rh, **F32)
    full, *_ = t_model.forward(dataclasses.replace(tcfg, sliding_window=None),
                               tparams, torch.from_numpy(tok))
    moved = (full - th).abs().amax(dim=(0, 2))
    assert float(moved[:32].max()) == 0.0
    assert float(moved[32:].min()) > 1e-3


# ---------------------------------------------------------------------------
# prefill, decode and the serving engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference(arch, f32):
    """A 40-token prompt (past h2o-danube's smoke window of 32), then three
    greedy decode steps, against the reference's caches and logits."""
    rcfg, tcfg, rparams, tparams, _ = setup_for(arch)
    prompt = tokens((2, 40), tcfg.vocab, seed=6)
    rlog, rc, _ = r_model.prefill(rcfg, rparams,
                                  jnp.asarray(prompt, jnp.int32), 64)
    tlog, tc, _ = t_model.prefill(tcfg, tparams, torch.from_numpy(prompt), 64)
    close(tlog, rlog, **F32)
    for kv in ("k", "v"):
        close(tc[0][1]["0"]["self"][kv],
              np.asarray(rc[0]["0"]["self"][kv][1]), **KV)
    pos = prompt.shape[1]
    for _ in range(3):
        nxt = np.array(jnp.argmax(rlog[:, -1], -1))[:, None]
        assert (nxt == torch.argmax(tlog[:, -1], -1)[:, None].numpy()).all()
        rlog, rc = r_model.decode_step(rcfg, rparams, rc,
                                       jnp.asarray(nxt, jnp.int32), pos)
        tlog, tc = t_model.decode_step(tcfg, tparams, tc,
                                       torch.from_numpy(nxt), pos)
        close(tlog, rlog, **F32)
        pos += 1


def _recording(fn, out):
    def wrapped(*a, **k):
        res = fn(*a, **k)
        out.append(np.asarray(res[0], np.float32) if not isinstance(
            res[0], torch.Tensor) else res[0].float().numpy())
        return res
    return wrapped


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference(arch, f32, monkeypatch):
    rcfg, tcfg, rparams, tparams, _ = setup_for(arch)
    rng = np.random.default_rng(8)
    specs = [(rng.integers(0, tcfg.vocab, int(rng.integers(3, 20))).tolist(),
              int(rng.integers(3, 7))) for _ in range(5)]
    r_eng = r_engine.ServeEngine(rcfg, rparams, n_slots=4, max_seq=64)
    r_steps: list = []
    r_eng._decode = _recording(r_eng._decode, r_steps)
    t_steps: list = []
    monkeypatch.setattr(t_model, "decode_step",
                        _recording(t_model.decode_step, t_steps))
    t_eng = t_engine.ServeEngine(tcfg, tparams, n_slots=4, max_seq=64)
    r_reqs = [r_engine.Request(rid=i, prompt=p, max_new_tokens=n)
              for i, (p, n) in enumerate(specs)]
    t_reqs = [t_engine.Request(rid=i, prompt=p, max_new_tokens=n)
              for i, (p, n) in enumerate(specs)]
    for r in r_reqs:
        r_eng.submit(r)
    for r in t_reqs:
        t_eng.submit(r)
    assert t_eng.run() == r_eng.run()
    assert len(t_steps) == len(r_steps) > 0
    for got, want in zip(t_steps, r_steps):
        np.testing.assert_allclose(got, want, **F32)
    for r, t in zip(r_reqs, t_reqs):
        assert t.done and r.done
        assert t.output == r.output, (t.rid, t.output, r.output)
