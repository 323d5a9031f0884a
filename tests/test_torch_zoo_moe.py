"""The port's mixture-of-experts architectures at smoke size vs the reference.

phi3.5-moe-42b-a6.6b (top-2) and llama4-scout-17b-a16e (top-1 plus a
shared expert) through ``smoke_config`` (d_model 64, GQA 4/2, two ``moe``
layers of 4 experts with d_ff 64): the same numpy weights
(``convert.init_numpy``) and numpy tokens go through both packages, the
reference with ``attn_impl="xla"``, the port with ``attn_impl="torch"``
on the CPU.  The experts each package routes to are recorded at its top-k
(the port's ``layers.top_k``; the reference's ``jax.lax.top_k`` through a
``jax.debug.callback``, which runs inside its scan).

Tolerances, each with its reason:
* float32 compute (``COMPUTE_DTYPE`` set to float32 in both packages):
  the routed experts **equal**, in every layer and for every token;
  2e-4 absolute and relative on hidden states, logits, loss, the
  auxiliary loss and decode logits (summation order only).
* bfloat16 as shipped: the router's logits are a bfloat16 product in both
  packages, and one ulp of difference in a layer's input flips a choice
  between two near-equal gates; the shifted running counts of its
  experts can also move which later token is the last to fit their
  capacity.  Routing (experts or capacity) may differ for at most 3 % of
  the tokens of a layer (measured 0-0.8 %: 0 or 1 token of 128 per layer
  over four draws).  Hidden states of tokens routed alike in every layer
  hold the dense limits (0.1 + 2e-2 relative; measured 0.031); a token
  routed elsewhere moves by up to one expert's output (measured 0.19), so
  every token holds 0.3.  Logits and loss 2e-2; the auxiliary loss, which
  counts first choices, 2e-2 (a flipped first choice moves it by
  n_experts / T times a gate mean: measured 0.002).
* the K/V cache, bfloat16 under float32 compute: one bfloat16 ulp.
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
from repro.models import layers as r_layers
from repro.models import model as r_model
from repro.serve import engine as r_engine
from repro_torch import configs as t_configs
from repro_torch.models import config as t_config
from repro_torch.models import convert
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.serve import engine as t_engine

torch.set_num_threads(2)
F32 = dict(atol=2e-4, rtol=2e-4)
KV = dict(atol=2e-4, rtol=2 ** -7)
ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]
ROUTING_SHARE_LIMIT = 0.03
_SETUPS: dict = {}


def setup_for(arch: str):
    """(reference config, port config, reference params, port params, numpy
    tree) at smoke size, built once per architecture."""
    if arch not in _SETUPS:
        rcfg = r_config.smoke_config(r_configs.get(arch))
        tcfg = convert.config_from_reference(rcfg)
        tree = convert.init_numpy(tcfg, seed=0)
        _SETUPS[arch] = (rcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                         convert.from_reference(tcfg, tree, device="cpu"),
                         tree)
    return _SETUPS[arch]


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(r_model, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_model, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture
def routing(monkeypatch):
    """Lists that collect each top-k call's expert ids, (T, k) numpy
    arrays in layer order: the reference's and the port's."""
    ref, port = [], []
    r_top_k, t_top_k = jax.lax.top_k, t_layers.top_k

    def r_rec(gates, k):
        vals, idx = r_top_k(gates, k)
        jax.debug.callback(lambda i: ref.append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx

    def t_rec(gates, k):
        vals, idx = t_top_k(gates, k)
        port.append(idx.numpy())
        return vals, idx
    monkeypatch.setattr(jax.lax, "top_k", r_rec)
    monkeypatch.setattr(t_layers, "top_k", t_rec)
    return ref, port


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def close(got, want, **kw):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **kw)


def forward_both(arch: str, s: int, seed: int = 1):
    rcfg, tcfg, rparams, tparams, _ = setup_for(arch)
    tok = tokens((2, s), tcfg.vocab, seed=seed)
    lab = tokens((2, s), tcfg.vocab, seed=seed + 1)
    rh, raux, *_ = r_model.forward(rcfg, rparams,
                                   jnp.asarray(tok, jnp.int32))
    jax.effects_barrier()
    th, taux, *_ = t_model.forward(tcfg, tparams, torch.from_numpy(tok))
    rl = r_model.unembed(rcfg, rparams, rh)
    tl = t_model.unembed(tcfg, tparams, th)
    rloss, rparts = r_model.loss_fn(rcfg, rparams, {
        "tokens": jnp.asarray(tok, jnp.int32),
        "labels": jnp.asarray(lab, jnp.int32)})
    tloss, tparts = t_model.loss_fn(tcfg, tparams, {
        "tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})
    return (rh, raux, rl, rloss, rparts), (th, taux, tl, tloss, tparts)


def dispatch(idx, moe):
    """A layer's (T, k) experts sorted per token, and which choices keep a
    slot: the capacity of ``moe_block``, filled in token-major order."""
    t, k = idx.shape
    cap = max(int(np.ceil(t * k * moe.capacity_factor / moe.n_experts)), 4)
    flat = idx.reshape(-1)
    count = np.cumsum(np.eye(moe.n_experts, dtype=np.int64)[flat], axis=0)
    kept = (count[np.arange(flat.size), flat] <= cap).reshape(t, k)
    order = np.argsort(idx, -1, kind="stable")
    return (np.take_along_axis(idx, order, -1),
            np.take_along_axis(kept, order, -1))


def routed_elsewhere(ref, port, moe, n_layers: int):
    """(layers, T) mask of the tokens routed otherwise in the packages'
    first forward (both record loss_fn's forward after it): another set of
    experts, or a choice that keeps its slot in one package and overflows
    the capacity in the other (a token routed elsewhere shifts the running
    counts of its experts, and with them the last token to fit)."""
    assert len(ref) >= n_layers and len(port) >= n_layers
    out = []
    for r, t in zip(ref[:n_layers], port[:n_layers]):
        (ir, kr), (it, kt) = dispatch(r, moe), dispatch(t, moe)
        out.append((ir != it).any(-1) | (kr != kt).any(-1))
    return np.stack(out)


# ---------------------------------------------------------------------------
# configuration and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_parameter_count_equal_the_reference(arch):
    full_r, full_t = r_configs.get(arch), t_configs.get(arch)
    assert full_t.attn_impl == "cuda" and full_t.family == "moe"
    assert convert.config_from_reference(
        dataclasses.replace(full_r, attn_impl="pallas")) == full_t
    assert t_config.smoke_config(full_t, attn_impl="torch") == \
        convert.config_from_reference(r_config.smoke_config(full_r))
    n_t = sum(t.numel() for t in t_model.L.tree_leaves(
        t_model.abstract_params(full_t)))
    n_r = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        r_model.abstract_params(full_r)))
    assert n_t == n_r == full_t.param_count() == full_r.param_count()
    assert full_t.active_param_count() == full_r.active_param_count()


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
    moe = tparams["stages"][0][1]["0"]["moe"]
    assert tuple(moe["wg"].shape) == (4, 64, 64)
    assert ("shared" in moe) == tcfg.moe.shared_expert
    if tcfg.moe.shared_expert:
        np.testing.assert_array_equal(
            moe["shared"]["wd"].numpy(),
            tree["stages"][0]["0"]["moe"]["shared"]["wd"][1])


# ---------------------------------------------------------------------------
# forward, loss with the auxiliary loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_aux_and_routing_match_reference_float32(
        arch, f32, routing):
    (rh, raux, rl, rloss, rparts), (th, taux, tl, tloss, tparts) = \
        forward_both(arch, 40)
    tcfg = setup_for(arch)[1]
    flips = routed_elsewhere(*routing, tcfg.moe, tcfg.n_layers)
    assert not flips.any(), flips.sum(-1)
    assert routing[1][0].shape == (80, tcfg.moe.top_k)
    close(th, rh, **F32)
    close(tl, rl, **F32)
    # aux: summed over both moe layers, and weighted into the loss
    assert float(taux) == pytest.approx(float(raux), rel=2e-4, abs=2e-4)
    assert float(taux) > 0
    assert float(tparts["aux"]) == pytest.approx(float(taux), rel=1e-6)
    assert float(tloss) == pytest.approx(float(rloss), rel=2e-4, abs=2e-4)
    assert float(tloss - tparts["ce"]) == pytest.approx(
        tcfg.moe.router_aux_weight * float(taux), rel=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_match_reference_bfloat16(arch, routing):
    (rh, raux, rl, rloss, _), (th, taux, tl, tloss, _) = \
        forward_both(arch, 64, seed=3)
    tcfg = setup_for(arch)[1]
    assert th.dtype == torch.bfloat16
    flips = routed_elsewhere(*routing, tcfg.moe, tcfg.n_layers)
    assert flips.mean(-1).max() <= ROUTING_SHARE_LIMIT, flips.mean(-1)
    alike = ~flips.any(0).reshape(2, 64)
    diff = np.abs(th.float().numpy() - np.asarray(rh, np.float32))
    limit = 0.1 + 2e-2 * np.abs(np.asarray(rh, np.float32))
    assert (diff[alike] <= limit[alike]).all(), diff[alike].max()
    assert diff.max() <= 0.3
    close(tl[torch.from_numpy(alike)], np.asarray(rl)[alike], atol=2e-2,
          rtol=2e-2)
    assert float(tloss) == pytest.approx(float(rloss), abs=2e-2)
    assert float(taux) == pytest.approx(float(raux), abs=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_gates_and_full_experts_match_reference(arch, f32, routing):
    """One moe layer, called alone on the same input, with a zero router:
    every gate ties, both packages pick experts 0..k-1 (the lower id first,
    as ``jax.lax.top_k`` orders ties), and 2 x 64 tokens overflow their
    experts' capacity of ceil(128 k 1.25 / 4) slots (40 at top-1, 80 at
    top-2), so the token-major slot order decides which tokens fall
    through."""
    rcfg, tcfg, _, _, tree = setup_for(arch)
    layer = jax.tree.map(lambda a: a[0], tree["stages"][0]["0"]["moe"])
    layer["router"] = np.zeros_like(layer["router"])
    x = np.random.default_rng(4).standard_normal((2, 64, 64)).astype(
        np.float32)
    ro, raux = r_layers.moe_block(rcfg, jax.tree.map(jnp.asarray, layer),
                                  jnp.asarray(x))
    jax.effects_barrier()
    to, taux = t_layers.moe_block(
        tcfg, t_layers.tree_map(torch.from_numpy, layer), torch.from_numpy(x))
    k = tcfg.moe.top_k
    for ids in routing:
        assert (ids[-1] == np.arange(k)).all()
    close(to, ro, **F32)
    assert float(taux) == pytest.approx(float(raux), rel=1e-6)
    # tokens past the capacity add nothing: their residual comes through
    cap = int(np.ceil(128 * k * 1.25 / 4))
    xt = x.reshape(128, 64)
    dropped = np.abs(to.reshape(128, 64).numpy() - xt).max(-1) == 0
    if not tcfg.moe.shared_expert:
        assert dropped.sum() == 128 - cap and not dropped[:cap].any()


# ---------------------------------------------------------------------------
# prefill, decode and the serving engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference(arch, f32):
    rcfg, tcfg, rparams, tparams, _ = setup_for(arch)
    prompt = tokens((2, 21), tcfg.vocab, seed=6)
    rlog, rc, _ = r_model.prefill(rcfg, rparams,
                                  jnp.asarray(prompt, jnp.int32), 48)
    tlog, tc, _ = t_model.prefill(tcfg, tparams, torch.from_numpy(prompt), 48)
    close(tlog, rlog, **F32)
    close(tc[0][1]["0"]["self"]["k"], np.asarray(rc[0]["0"]["self"]["k"][1]),
          **KV)
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
    rng = np.random.default_rng(9)
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
