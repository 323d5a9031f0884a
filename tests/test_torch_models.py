"""The port's model zoo path on Zamba2-1.2B at smoke size vs the reference.

``smoke_config(zamba2-1.2b)`` (d_model 64, GQA 4/2, one ("mamba",
"hybrid") unit, d_state 16, chunk 16) runs through both packages on the
same numpy weights (``convert.init_numpy``, carried across with
``from_reference`` / ``to_reference``) and the same numpy tokens.  The
reference runs with ``attn_impl="xla"`` as its own tests do (and
``"pallas"`` in interpret mode once); the port with ``attn_impl="torch"``,
its plain route on the CPU.

Tolerances, each with its reason:
* float32 compute (``COMPUTE_DTYPE`` set to float32 in both packages by
  ``monkeypatch``, in this process only): 2e-4 absolute and relative on
  hidden states, logits, loss and decode logits — summation order only
  (measured 1.4e-6 on hidden states of magnitude 4).
* bfloat16 as shipped: hidden states 0.1, logits and loss 2e-2 — both
  packages round every layer's output to bfloat16 but at different
  points inside fused ops, so the 3-layer stack drifts by a few bfloat16
  ulps (measured 0.031 on hidden states of magnitude 4, 0.0059 on logits);
  never looser than ``tests/test_archs.py``'s 0.15.
* serving, float32 compute: per-step logits 2e-4, greedy tokens equal.
"""
import dataclasses
import inspect

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


@pytest.fixture(scope="module")
def setup():
    rcfg = r_config.smoke_config(r_configs.get("zamba2-1.2b"))
    tcfg = convert.config_from_reference(rcfg)
    tree = convert.init_numpy(tcfg, seed=0)
    rparams = jax.tree.map(jnp.asarray, tree)
    tparams = convert.from_reference(tcfg, tree, device="cpu")
    return rcfg, tcfg, rparams, tparams


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(r_model, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_model, "COMPUTE_DTYPE", torch.float32)


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def close(got, want, **kw):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **kw)


# ---------------------------------------------------------------------------
# configuration and parameters
# ---------------------------------------------------------------------------
def test_config_carries_across(setup):
    rcfg, tcfg, _, _ = setup
    assert tcfg.attn_impl == "torch" and rcfg.attn_impl == "xla"
    assert tcfg == t_config.smoke_config(t_configs.get("zamba2-1.2b"),
                                         attn_impl="torch")
    assert r_config.ModelConfig(**{
        **convert.config_to_reference(tcfg),
        "ssm": r_config.SSMConfig(**dataclasses.asdict(tcfg.ssm))}) == rcfg
    full_r, full_t = r_configs.get("zamba2-1.2b"), t_configs.get("zamba2-1.2b")
    assert full_t.attn_impl == "cuda"
    assert convert.config_from_reference(
        dataclasses.replace(full_r, attn_impl="pallas")) == full_t
    assert full_t.param_count() == full_r.param_count() == 1_170_466_560


def test_other_archs_and_unported_paths_raise():
    """Every architecture of the reference's registry resolves (the
    cross-attention ones since their slice); an unknown id and an
    attention route the port does not have still raise, and the
    distribution layer's ``"seq_shard"`` resolves and crosses to the
    reference by its own name."""
    assert list(t_configs.ARCHS) == list(r_configs.ARCHS)
    for name in ("whisper-small", "llama-3.2-vision-11b"):
        assert t_configs.get(name).name == name
    with pytest.raises(KeyError):
        t_configs.get("gpt-5")
    cfg = t_configs.get("zamba2-1.2b")
    seq = dataclasses.replace(cfg, attn_impl="seq_shard")
    assert convert.config_to_reference(seq)["attn_impl"] == "seq_shard"
    assert convert.config_from_reference(
        dataclasses.replace(r_configs.get("zamba2-1.2b"),
                            attn_impl="seq_shard")) == seq
    with pytest.raises(ValueError, match="attn_impl"):
        dataclasses.replace(cfg, attn_impl="pallas")
    cross = dataclasses.replace(cfg, stages=((("cross",), 38),), ssm=None)
    assert "xattn" in t_model.model_meta(cross)["stages"][0][0]["0"]


def test_parameters_round_trip_with_reference_shapes(setup):
    rcfg, tcfg, _, tparams = setup
    tree = convert.init_numpy(tcfg, seed=0)
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
    # the port's own shapes: one unit dict per repeat, meta tensors
    shapes = t_model.abstract_params(tcfg)
    assert [len(s) for s in shapes["stages"]] == [r for _, r in tcfg.stages]
    assert shapes["embed"].device.type == "meta"


def test_from_reference_defaults_to_the_card(setup):
    """Weights carried across land on the card unless the caller asks for
    the CPU, as the fixture does; there they equal the numpy tree."""
    _, tcfg, _, tparams = setup
    device = inspect.signature(convert.from_reference).parameters["device"]
    assert device.default == "cuda"
    leaves = t_model.L.tree_leaves(tparams)
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    tree = convert.init_numpy(tcfg, seed=0)
    np.testing.assert_array_equal(tparams["embed"].numpy(), tree["embed"])
    again = convert.from_reference(tcfg, tree, device="cpu")
    for x, y in zip(leaves, t_model.L.tree_leaves(again)):
        assert torch.equal(x, y)


def test_init_params_draws_the_reference_distributions():
    cfg = t_config.smoke_config(t_configs.get("zamba2-1.2b"),
                                attn_impl="torch")
    p = t_model.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    m = p["stages"][0][0]["0"]["mamba"]
    a = torch.exp(m["a_log"])
    assert ((a >= 1) & (a <= 16)).all()
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert ((dt >= 1e-3 - 1e-6) & (dt <= 0.1 + 1e-6)).all()
    assert (m["d_skip"] == 1).all() and (m["gate_norm"] == 1).all()
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    assert abs(float(m["conv_x"].std()) - 0.2) < 0.03
    again = t_model.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(again["embed"], p["embed"])


# ---------------------------------------------------------------------------
# forward, unembed, loss
# ---------------------------------------------------------------------------
def _forward_both(setup, s):
    rcfg, tcfg, rparams, tparams = setup
    tok = tokens((2, s), tcfg.vocab, seed=1)
    lab = tokens((2, s), tcfg.vocab, seed=2)
    rh, *_ = r_model.forward(rcfg, rparams, jnp.asarray(tok, jnp.int32))
    th, *_ = t_model.forward(tcfg, tparams, torch.from_numpy(tok))
    rl = r_model.unembed(rcfg, rparams, rh)
    tl = t_model.unembed(tcfg, tparams, th)
    rloss, _ = r_model.loss_fn(rcfg, rparams, {
        "tokens": jnp.asarray(tok, jnp.int32),
        "labels": jnp.asarray(lab, jnp.int32)})
    tloss, aux = t_model.loss_fn(tcfg, tparams, {
        "tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})
    assert float(aux["aux"]) == 0.0
    return (rh, rl, rloss), (th, tl, tloss)


def test_forward_loss_match_reference_float32(setup, f32):
    # S 40 does not tile by the chunk of 16: ops.ssd's padding runs
    (rh, rl, rloss), (th, tl, tloss) = _forward_both(setup, 40)
    assert th.dtype == torch.float32 and th.shape == (2, 40, 64)
    close(th, rh, **F32)
    close(tl, rl, **F32)
    assert float(tloss) == pytest.approx(float(rloss), rel=2e-4, abs=2e-4)


def test_forward_loss_match_reference_bfloat16(setup):
    (rh, rl, rloss), (th, tl, tloss) = _forward_both(setup, 64)
    assert th.dtype == torch.bfloat16
    close(th, rh, atol=0.1, rtol=2e-2)
    close(tl, rl, atol=2e-2, rtol=2e-2)
    assert float(tloss) == pytest.approx(float(rloss), abs=2e-2)
    assert float(tloss) == pytest.approx(np.log(setup[1].vocab), rel=0.15)


def test_forward_matches_reference_pallas_route(setup):
    """The reference's kernels (interpret mode) against the port's plain
    route, bfloat16 as shipped."""
    rcfg, tcfg, rparams, tparams = setup
    tok = tokens((2, 32), tcfg.vocab, seed=5)
    rh, *_ = r_model.forward(dataclasses.replace(rcfg, attn_impl="pallas"),
                             rparams, jnp.asarray(tok, jnp.int32))
    th, *_ = t_model.forward(tcfg, tparams, torch.from_numpy(tok))
    close(th, rh, atol=0.1, rtol=2e-2)


def test_cuda_route_raises_without_cuda_tensors(setup):
    _, tcfg, _, tparams = setup
    cuda_cfg = dataclasses.replace(tcfg, attn_impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        t_model.forward(cuda_cfg, tparams,
                        torch.zeros((1, 16), dtype=torch.long))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            t_model.init_params(cuda_cfg)


# ---------------------------------------------------------------------------
# prefill, decode and the serving engine
# ---------------------------------------------------------------------------
def test_prefill_decode_match_reference(setup, f32):
    rcfg, tcfg, rparams, tparams = setup
    prompt = tokens((2, 21), tcfg.vocab, seed=6)
    rlog, rc, _ = r_model.prefill(rcfg, rparams, jnp.asarray(prompt,
                                                              jnp.int32), 48)
    tlog, tc, _ = t_model.prefill(tcfg, tparams, torch.from_numpy(prompt), 48)
    close(tlog, rlog, **F32)
    ssm_r = np.asarray(rc[0]["0"]["mamba"]["ssm"][0])
    close(tc[0][0]["0"]["mamba"]["ssm"], ssm_r, **F32)
    pos = prompt.shape[1]
    for step in range(3):
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


def test_serve_engine_matches_reference(setup, f32, monkeypatch):
    rcfg, tcfg, rparams, tparams = setup
    rng = np.random.default_rng(7)
    specs = [(rng.integers(0, tcfg.vocab, int(rng.integers(3, 20))).tolist(),
              int(rng.integers(3, 9))) for _ in range(6)]
    r_eng = r_engine.ServeEngine(rcfg, rparams, n_slots=4, max_seq=96)
    r_steps: list = []
    r_eng._decode = _recording(r_eng._decode, r_steps)
    t_steps: list = []
    monkeypatch.setattr(t_model, "decode_step",
                        _recording(t_model.decode_step, t_steps))
    t_eng = t_engine.ServeEngine(tcfg, tparams, n_slots=4, max_seq=96)
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
        assert len(t.output) == t.max_new_tokens


@pytest.mark.cuda
def test_cuda_forward_matches_plain_route():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attention, ssd_scan
    cfg = t_config.smoke_config(t_configs.get("zamba2-1.2b"))
    params = t_model.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    tok = torch.from_numpy(tokens((2, 64), cfg.vocab, seed=1)).cuda()
    flash_attention.reset_launches()
    ssd_scan.reset_launches()
    hk, *_ = t_model.forward(cfg, params, tok)
    assert (flash_attention.launches, ssd_scan.launches) == (1, 2)
    hp, *_ = t_model.forward(dataclasses.replace(cfg, attn_impl="torch"),
                             params, tok)
    torch.testing.assert_close(hk.float(), hp.float(), atol=0.1, rtol=2e-2)
