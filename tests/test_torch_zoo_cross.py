"""The port's cross-attention architectures at smoke size vs the reference.

whisper-small (an encoder of 2 bidirectional layers over 32 stub frames,
2 ``cross`` decoder layers, LayerNorm and GELU) and llama-3.2-vision-11b
(one ("attn", "cross") unit over 16 stub image embeddings) through
``smoke_config``: the same numpy weights (``convert.init_numpy``), tokens
and memory inputs go through both packages, the reference with
``attn_impl="xla"`` and the port with ``attn_impl="torch"``, its plain
route on the CPU.  The flash wrapper is also held at ragged lengths (none
tiling by 128) against the reference's ``attention_ref``, the function the
reference runs at whisper's and the vision model's lengths.

Tolerances (those of ``tests/test_torch_zoo_dense.py``, with their
reasons):
* float32 compute (``COMPUTE_DTYPE`` set to float32 in both packages):
  1e-4 absolute and relative on hidden states, memory, logits, loss and
  decode logits; summation order only (measured under 2e-6).
* bfloat16 as shipped: hidden states 0.1 + 2e-2 relative, logits and loss
  2e-2 (measured 0.04 on hidden states, 0.004 on decode logits).
* the K/V caches, which stay bfloat16 under float32 compute: one bfloat16
  ulp (2**-7 relative).
* the flash wrapper on CPU tensors in float32: 2e-5 (the kernel's own
  tolerance against its plain version).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.kernels import ref as r_kref
from repro.models import config as r_config
from repro.models import model as r_model
from repro.serve import engine as r_engine
from repro_torch import configs as t_configs
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.models import config as t_config
from repro_torch.models import convert
from repro_torch.models import model as t_model
from repro_torch.serve import engine as t_engine

torch.set_num_threads(2)
F32 = dict(atol=1e-4, rtol=1e-4)
KV = dict(atol=1e-4, rtol=2 ** -7)
ARCHS = ["whisper-small", "llama-3.2-vision-11b"]
PARAM_COUNTS = {"whisper-small": 277_892_352,
                "llama-3.2-vision-11b": 10_110_734_336}
# Parameters that ModelConfig.param_count leaves out, in both packages:
# whisper's encoder positions (1 500 x 768) and 183 vectors of width 768
# (the LayerNorm biases, the GELU MLPs' biases b1 of 4 x 768 and b2, the
# encoder's final norm).
ABSENT_FROM_COUNT = {"whisper-small": 1500 * 768 + 183 * 768,
                     "llama-3.2-vision-11b": 0}
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


def close(got, want, **kw):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **kw)


def inputs(cfg, batch: int, seq: int, seed: int):
    """Numpy tokens, labels and the memory input (frames or image
    embeddings, float32 standard normals) with its batch key."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (batch, seq))
    lab = rng.integers(0, cfg.vocab, (batch, seq))
    key = "frames" if cfg.encoder_layers else "img_embeds"
    mem = rng.standard_normal((batch, cfg.encoder_seq or cfg.n_img_tokens,
                               cfg.d_model)).astype(np.float32)
    return tok, lab, key, mem


def batches(tok, lab, key, mem):
    """The same batch for both packages, the memory in the compute dtype
    (bfloat16 as the reference's input specs give it, or float32 under
    the f32 fixture)."""
    r = {"tokens": jnp.asarray(tok, jnp.int32),
         "labels": jnp.asarray(lab, jnp.int32),
         key: jnp.asarray(mem, r_model.COMPUTE_DTYPE)}
    t = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
         key: torch.from_numpy(mem).to(t_model.COMPUTE_DTYPE)}
    return r, t


def forward_both(arch: str, seq: int, seed: int = 1):
    """(hidden, memory, logits, loss) of both packages."""
    rcfg, tcfg, rparams, tparams, _ = setup_for(arch)
    tok, lab, key, mem = inputs(tcfg, 2, seq, seed)
    rb, tb = batches(tok, lab, key, mem)
    rh, _, _, rm = r_model.forward(rcfg, rparams, rb["tokens"],
                                   **{key: rb[key]})
    th, _, _, tm = t_model.forward(tcfg, tparams, tb["tokens"],
                                   **{key: tb[key]})
    rloss, _ = r_model.loss_fn(rcfg, rparams, rb)
    tloss, _ = t_model.loss_fn(tcfg, tparams, tb)
    return ((rh, rm, r_model.unembed(rcfg, rparams, rh), rloss),
            (th, tm, t_model.unembed(tcfg, tparams, th), tloss))


# ---------------------------------------------------------------------------
# configuration and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_parameter_count_equal_the_reference(arch):
    full_r, full_t = r_configs.get(arch), t_configs.get(arch)
    assert full_t.attn_impl == "cuda"
    assert convert.config_from_reference(
        dataclasses.replace(full_r, attn_impl="pallas")) == full_t
    assert t_config.smoke_config(full_t, attn_impl="torch") == \
        convert.config_from_reference(r_config.smoke_config(full_r))
    n_t = sum(t.numel() for t in t_model.L.tree_leaves(
        t_model.abstract_params(full_t)))
    n_r = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        r_model.abstract_params(full_r)))
    assert full_t.param_count() == full_r.param_count() == PARAM_COUNTS[arch]
    # the parameters themselves, alike in both packages (ROADMAP, Queue 3)
    assert n_t == n_r == PARAM_COUNTS[arch] + ABSENT_FROM_COUNT[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_round_trip_with_reference_shapes(arch):
    """The encoder's stacked stages cross like the decoder's, with the
    leading repeats axis."""
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
        assert tuple(want.shape) == got.shape
    assert "bq" not in tparams["stages"][0][0][
        str(len(tcfg.stages[0][0]) - 1)]["xattn"]
    if tcfg.encoder_layers:
        assert tree["encoder"]["stages"][0]["0"]["attn"]["wq"].shape[0] == \
            tcfg.encoder_layers == len(tparams["encoder"]["stages"][0])


# ---------------------------------------------------------------------------
# forward, unembed, loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_match_reference_float32(arch, f32):
    (rh, rm, rl, rloss), (th, tm, tl, tloss) = forward_both(arch, 24)
    assert th.dtype == torch.float32 and th.shape == (2, 24, 64)
    close(th, rh, **F32)
    close(tm, rm, **F32)
    close(tl, rl, **F32)
    assert float(tloss) == pytest.approx(float(rloss), rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_match_reference_bfloat16(arch):
    (rh, rm, rl, rloss), (th, tm, tl, tloss) = forward_both(arch, 40, seed=3)
    assert th.dtype == torch.bfloat16
    close(th, rh, atol=0.1, rtol=2e-2)
    close(tm, rm, atol=0.1, rtol=2e-2)
    close(tl, rl, atol=2e-2, rtol=2e-2)
    assert float(tloss) == pytest.approx(float(rloss), abs=2e-2)
    assert float(tloss) == pytest.approx(np.log(256), rel=0.15)


def test_memory_reaches_the_decoder():
    """Another memory moves every decoder position (cross-attention is not
    causal), and the vision model's memory is its image embeddings."""
    for arch in ARCHS:
        _, tcfg, _, tparams, _ = setup_for(arch)
        tok, _, key, mem = inputs(tcfg, 1, 12, seed=4)
        other = inputs(tcfg, 1, 12, seed=5)[3]
        outs = [t_model.forward(tcfg, tparams, torch.from_numpy(tok),
                                **{key: torch.from_numpy(m).bfloat16()})
                for m in (mem, other)]
        moved = (outs[0][0] - outs[1][0]).float().abs().amax(dim=(0, 2))
        assert float(moved.min()) > 0.0, arch
        if key == "img_embeds":
            assert torch.equal(outs[0][3], torch.from_numpy(mem).bfloat16())


# ---------------------------------------------------------------------------
# prefill, decode, the cross cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_cross_cache_match_reference(arch, f32):
    """A 10-token prompt with its memory, then three greedy decode steps
    against the cached cross K/V, against the reference's caches and
    logits; and each step given the memory anew (K/V projected again, in
    float32 rather than from the bfloat16 cache) against the reference's
    step given it."""
    rcfg, tcfg, rparams, tparams, _ = setup_for(arch)
    tok, _, key, mem = inputs(tcfg, 2, 10, seed=6)
    rb, tb = batches(tok, tok, key, mem)
    rlog, rc, rmem = r_model.prefill(rcfg, rparams, rb["tokens"], 32,
                                     **{key: rb[key]})
    tlog, tc, tmem = t_model.prefill(tcfg, tparams, tb["tokens"], 32,
                                     **{key: tb[key]})
    close(tlog, rlog, **F32)
    close(tmem, rmem, **F32)
    mem_len = tcfg.encoder_seq or tcfg.n_img_tokens
    i = str(len(tcfg.stages[0][0]) - 1)          # the unit's cross layer
    for kv in ("k", "v"):
        assert tc[0][0][i]["cross"][kv].shape == (2, tcfg.n_kv_heads,
                                                  mem_len, tcfg.hd)
        close(tc[0][0][i]["cross"][kv],
              np.asarray(rc[0][i]["cross"][kv][0]), **KV)
        close(tc[0][0][i]["self"][kv],
              np.asarray(rc[0][i]["self"][kv][0]), **KV)
    pos = tok.shape[1]
    for _ in range(3):
        nxt = np.array(jnp.argmax(rlog[:, -1], -1))[:, None]
        assert (nxt == torch.argmax(tlog[:, -1], -1)[:, None].numpy()).all()
        r_again, _ = r_model.decode_step(rcfg, rparams, rc,
                                         jnp.asarray(nxt, jnp.int32), pos,
                                         memory=rmem)
        t_again, _ = t_model.decode_step(tcfg, tparams, tc,
                                         torch.from_numpy(nxt), pos,
                                         memory=tmem)
        close(t_again, r_again, **F32)
        rlog, rc = r_model.decode_step(rcfg, rparams, rc,
                                       jnp.asarray(nxt, jnp.int32), pos)
        tlog, tc = t_model.decode_step(tcfg, tparams, tc,
                                       torch.from_numpy(nxt), pos)
        close(tlog, rlog, **F32)
        pos += 1


def test_serve_engine_runs_cross_models_like_the_reference(f32,
                                                           monkeypatch):
    """The engine takes no memory, in both packages: cross layers attend
    over the zero cross cache.  Per-step logits and greedy tokens equal
    the reference's."""
    rcfg, tcfg, rparams, tparams, _ = setup_for("llama-3.2-vision-11b")
    rng = np.random.default_rng(8)
    specs = [(rng.integers(0, tcfg.vocab, int(rng.integers(3, 12))).tolist(),
              int(rng.integers(2, 5))) for _ in range(3)]
    r_eng = r_engine.ServeEngine(rcfg, rparams, n_slots=2, max_seq=32)
    t_eng = t_engine.ServeEngine(tcfg, tparams, n_slots=2, max_seq=32)
    r_reqs = [r_engine.Request(rid=i, prompt=p, max_new_tokens=n)
              for i, (p, n) in enumerate(specs)]
    t_reqs = [t_engine.Request(rid=i, prompt=p, max_new_tokens=n)
              for i, (p, n) in enumerate(specs)]
    for r, t in zip(r_reqs, t_reqs):
        r_eng.submit(r)
        t_eng.submit(t)
    assert t_eng.run() == r_eng.run()
    for r, t in zip(r_reqs, t_reqs):
        assert t.done and r.done and t.output == r.output, t.rid


# ---------------------------------------------------------------------------
# routing to the kernel, and the wrappers at ragged lengths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,per_forward", [("whisper-small", 6),
                                              ("llama-3.2-vision-11b", 3)])
def test_cross_calls_reach_the_flash_wrapper(arch, per_forward,
                                             monkeypatch):
    """Under ``attn_impl="cuda"`` the cache-free forward sends every
    attention to the wrapper (whisper: 2 encoder, 2 decoder self, 2 cross
    at smoke size), prefill sends the cross layers and the encoder, and
    decode the cross layers only (one query row against the cached
    memory, no q_offset), as in the reference's routing."""
    _, tcfg, _, tparams, _ = setup_for(arch)
    cfg = dataclasses.replace(tcfg, attn_impl="cuda")
    monkeypatch.setattr(t_model, "_check_device", lambda *a: None)
    calls = []
    wrapper = t_flash.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return wrapper(q, k, v, **kw)
    monkeypatch.setattr(t_flash, "flash_attention", counting)
    tok, _, key, mem = inputs(cfg, 1, 9, seed=2)
    extra = {key: torch.from_numpy(mem).bfloat16()}
    hidden, *_ = t_model.forward(cfg, tparams, torch.from_numpy(tok),
                                 **extra)
    assert len(calls) == per_forward
    plain, *_ = t_model.forward(tcfg, tparams, torch.from_numpy(tok),
                                **extra)
    assert torch.equal(hidden, plain)
    n_cross = sum(u.count("cross") * r for u, r in cfg.stages)
    calls.clear()
    _, caches, _ = t_model.prefill(cfg, tparams, torch.from_numpy(tok),
                                        16, **extra)
    assert len(calls) == n_cross + cfg.encoder_layers
    calls.clear()
    t_model.decode_step(cfg, tparams, caches,
                        torch.zeros((1, 1), dtype=torch.long), 9)
    mem_len = cfg.encoder_seq or cfg.n_img_tokens
    assert calls == [(1, mem_len, False)] * n_cross


RAGGED = [  # (B, Hq, Hkv, Sq, Skv, D, causal): no length tiles by 128
    (1, 4, 2, 45, 45, 16, True),
    (2, 4, 4, 45, 93, 16, False),          # cross: queries over a memory
    (1, 4, 1, 1, 93, 32, False),           # one cross decode row
    (1, 2, 2, 150, 150, 16, False),        # an encoder past one tile
    (1, 2, 2, 130, 200, 16, True),         # queries at the kv tail
]


@pytest.mark.parametrize("case", RAGGED)
def test_flash_wrapper_takes_ragged_lengths(case):
    """No tiling precondition: on CPU tensors the wrapper runs its plain
    version at any length, equal to the reference's attention_ref."""
    b, hq, hkv, sq, skv, d, causal = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    got = t_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    want = r_kref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    close(got, want, atol=2e-5, rtol=2e-5)


def test_wrappers_carry_gradients_on_cpu_tensors():
    """On CPU tensors the wrappers run their plain versions, which
    autograd sees through."""
    q = torch.randn(1, 2, 45, 16, requires_grad=True)
    k = torch.randn(1, 2, 93, 16, requires_grad=True)
    t_flash.flash_attention(q, k, k, causal=False).sum().backward()
    assert q.grad is not None and bool(torch.isfinite(k.grad).all())
    x = torch.randn(1, 2, 32, 8, requires_grad=True)
    b = torch.randn(1, 1, 32, 4)
    t_ssd.ssd_scan(x, torch.rand(1, 2, 32), -torch.rand(2), b, b,
                   chunk=16).sum().backward()
    assert bool(torch.isfinite(x.grad).all())


@pytest.mark.cuda
def test_wrappers_raise_on_cuda_inputs_that_require_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    q = torch.randn(1, 2, 45, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(1, 2, 93, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        t_flash.flash_attention(q.requires_grad_(), k, k, causal=False)
    with torch.no_grad():
        out = t_flash.flash_attention(q, k, k, causal=False)
    torch.testing.assert_close(out.float(), t_flash.plain(
        q.detach(), k, k, causal=False).float(), atol=2e-2, rtol=2e-2)
    x = torch.randn(1, 2, 128, 64, device="cuda", requires_grad=True)
    b = torch.randn(1, 1, 128, 16, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        t_ssd.ssd_scan(x, torch.rand(1, 2, 128, device="cuda"),
                       -torch.rand(2, device="cuda"), b, b, chunk=64)
