"""The port's attention-free architecture, mamba2-1.3b, vs the reference.

``smoke_config(mamba2-1.3b)`` (d_model 64, two ``mamba`` layers, 8 SSD
heads of width 16, d_state 16, chunk 16) runs through both packages on
the same numpy weights (``convert.init_numpy``) and numpy tokens, the
reference with ``attn_impl="xla"`` (and ``"pallas"`` in interpret mode
once), the port with ``attn_impl="torch"``, its plain route on the CPU.
At full width mamba2-1.3b's d_state is 128: the float32 SSD kernel splits
P over two blocks per (batch, head) there, which ``ssd_scan.plan`` shows
here and ``chip_smoke.py`` runs on the card.

Tolerances (those of ``tests/test_torch_models.py``, with their reasons):
float32 compute 2e-4 absolute and relative on hidden states, logits, loss,
the SSM state and decode logits (summation order only); bfloat16 as
shipped 0.1 + 2e-2 relative on hidden states, 2e-2 on logits and loss;
serving in float32 compute, per-step logits 2e-4 and greedy tokens equal.
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
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.models import config as t_config
from repro_torch.models import convert
from repro_torch.models import model as t_model
from repro_torch.serve import engine as t_engine

torch.set_num_threads(2)
F32 = dict(atol=2e-4, rtol=2e-4)
ARCH = "mamba2-1.3b"


@pytest.fixture(scope="module")
def setup():
    rcfg = r_config.smoke_config(r_configs.get(ARCH))
    tcfg = convert.config_from_reference(rcfg)
    tree = convert.init_numpy(tcfg, seed=0)
    return (rcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.from_reference(tcfg, tree, device="cpu"), tree)


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
# configuration, parameters and the float32 kernel's plan
# ---------------------------------------------------------------------------
def test_config_and_parameter_count_equal_the_reference():
    full_r, full_t = r_configs.get(ARCH), t_configs.get(ARCH)
    assert full_t.attn_impl == "cuda" and full_t.family == "ssm"
    assert convert.config_from_reference(
        dataclasses.replace(full_r, attn_impl="pallas")) == full_t
    assert t_config.smoke_config(full_t, attn_impl="torch") == \
        convert.config_from_reference(r_config.smoke_config(full_r))
    assert (full_t.ssm.d_state, full_t.ssm.head_dim, full_t.n_ssm_heads) == \
        (128, 64, 64)
    n_t = sum(t.numel() for t in t_model.L.tree_leaves(
        t_model.abstract_params(full_t)))
    n_r = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        r_model.abstract_params(full_r)))
    assert n_t == n_r
    # param_count counts the skip D as d_inner values per layer where the
    # parameter has n_ssm_heads: both packages overcount alike
    assert full_t.param_count() == full_r.param_count() == n_t + 48 * (
        full_t.d_inner - full_t.n_ssm_heads) == n_t + 193_536


def test_parameters_round_trip_with_reference_shapes(setup):
    rcfg, tcfg, _, tparams, tree = setup
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
    assert "shared_attn" not in tparams
    assert [len(s) for s in tparams["stages"]] == [2]


def test_float32_ssd_plan_fits_d_state_128():
    """At full width (chunk 128, N 128, P 64) one float32 block would hold
    264 704 bytes; two blocks per (batch, head) hold 231 936 each, within
    the 232 448 a block may take.  The scoring shape has 2 x 64 pairs."""
    cfg = t_configs.get(ARCH)
    s = cfg.ssm
    args = (s.chunk, s.d_state, s.head_dim)
    assert t_ssd.plan(2 * cfg.n_ssm_heads, *args, torch.float32) == (
        2, t_ssd.SCALAR_THREADS, 231_936)
    assert t_ssd.shared_bytes(*args, 1, torch.float32) == 264_704
    assert t_ssd.plan(2 * cfg.n_ssm_heads, *args, torch.bfloat16)[2] <= \
        t_ssd.SHARED_LIMIT_BYTES


def test_splitting_p_over_blocks_is_exact():
    """Columns of y depend on the same columns of x alone, so the k blocks
    of a (batch, head) compute disjoint slices of the plain result."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((1, 4, 64, 32), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((1, 4, 64), generator=g))
    a = -torch.exp(torch.randn(4, generator=g) * 0.5)
    b, c = (torch.randn((1, 1, 64, 128), generator=g) for _ in range(2))
    whole = t_ssd.ssd_scan(x, dt, a, b, c, chunk=32)
    halves = [t_ssd.ssd_scan(x[..., i:i + 16].contiguous(), dt, a, b, c,
                             chunk=32) for i in (0, 16)]
    torch.testing.assert_close(torch.cat(halves, -1), whole, atol=1e-6,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# forward, loss, prefill, decode and the serving engine
# ---------------------------------------------------------------------------
def _forward_both(setup, s, seed=1):
    rcfg, tcfg, rparams, tparams, _ = setup
    tok = tokens((2, s), tcfg.vocab, seed=seed)
    lab = tokens((2, s), tcfg.vocab, seed=seed + 1)
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
    (rh, rl, rloss), (th, tl, tloss) = _forward_both(setup, 64, seed=3)
    assert th.dtype == torch.bfloat16
    close(th, rh, atol=0.1, rtol=2e-2)
    close(tl, rl, atol=2e-2, rtol=2e-2)
    assert float(tloss) == pytest.approx(float(rloss), abs=2e-2)


def test_forward_matches_reference_pallas_route(setup):
    """The reference's SSD kernel (interpret mode) against the port's plain
    route, bfloat16 as shipped."""
    rcfg, tcfg, rparams, tparams, _ = setup
    tok = tokens((2, 32), tcfg.vocab, seed=5)
    rh, *_ = r_model.forward(dataclasses.replace(rcfg, attn_impl="pallas"),
                             rparams, jnp.asarray(tok, jnp.int32))
    th, *_ = t_model.forward(tcfg, tparams, torch.from_numpy(tok))
    close(th, rh, atol=0.1, rtol=2e-2)


def test_prefill_decode_match_reference(setup, f32):
    rcfg, tcfg, rparams, tparams, _ = setup
    prompt = tokens((2, 21), tcfg.vocab, seed=6)
    rlog, rc, _ = r_model.prefill(rcfg, rparams,
                                  jnp.asarray(prompt, jnp.int32), 48)
    tlog, tc, _ = t_model.prefill(tcfg, tparams, torch.from_numpy(prompt), 48)
    close(tlog, rlog, **F32)
    for r in range(2):
        close(tc[0][r]["0"]["mamba"]["ssm"],
              np.asarray(rc[0]["0"]["mamba"]["ssm"][r]), **F32)
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


def test_serve_engine_matches_reference(setup, f32, monkeypatch):
    rcfg, tcfg, rparams, tparams, _ = setup
    rng = np.random.default_rng(10)
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
