"""The port's distribution layer in one process vs the reference.

Twins of every test of ``tests/test_sharding_spec.py`` and of the three
single-device tests of ``tests/test_dist.py``, each run on the port and
held to the live reference, then:

* ``quantize``, ``dequantize`` and ``quantize_with_feedback`` equal the
  reference bit for bit (codes, scales, residuals) on seeded numpy
  inputs, the all-zero input and ties at half a step included (both
  packages round half to even);
* ``fit_spec``, ``spec_for_axes`` and ``batch_entry`` equal the reference
  over a seeded grid of shapes, specs and meshes;
* ``param_specs`` and ``cache_specs`` (both ``seq_shard`` values) equal
  the reference for all ten configurations on both production meshes and
  on (2, 2, 2) and (2, 4), the port's spec of a stacked leaf being the
  reference's without its leading entry (the port keeps a stage's repeats
  as a list; that entry is always None);
* the 40 dry-run cells and their ``batch_specs`` equal the reference's;
* a smoke model with ``attn_impl="seq_shard"`` and no mesh: ``prefill`` +
  ``decode_step`` equal the reference's within the zoo tests' float32
  tolerance (2e-4 absolute and relative, summation order only);
* on a one-rank gloo mesh of shape (1, 1, 1): ``make_dp_grad_fn``'s
  ``flat`` and ``hier`` equal the plain value and gradient bit for bit
  (a sum and a mean over one rank are exact) and ``hier`` + int8 is
  within half an int8 step per element, ``scale / 2`` (one scale per
  reference leaf: a stage's repeats quantized together), to float32
  rounding: ``scale * (1/2 + 2**-16)`` (the quotient ``x / scale`` and the
  product ``q * scale`` each round once, by at most 2**-17 of the scale
  since ``|x| <= 127 * scale``): ``chip_smoke.py`` phase 20's checks at
  smoke size.

The reference's sharding functions read only ``mesh.axis_names`` and
``mesh.shape``, so they run here on a stand-in mesh (as its own tests
do), with no devices.  The multi-rank cases are
``tests/test_torch_dist_ranks.py``.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as RP
from torch.distributed.tensor import Replicate, Shard

from repro import configs as r_configs
from repro.dist import compression as r_comp
from repro.dist import context as r_ctx
from repro.dist import data_parallel as r_dp
from repro.dist import decode_attn as r_attn
from repro.dist import sharding as r_shd
from repro.launch import shapes as r_shapes
from repro.models import config as r_config
from repro.models import model as r_model
from repro_torch import configs as t_configs
from repro_torch.dist import collectives, compression, context
from repro_torch.dist import data_parallel
from repro_torch.dist import decode_attn, sharding
from repro_torch.dist.sharding import P
from repro_torch.kernels import ref as t_ref
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import shapes as t_shapes
from repro_torch.launch import steps as t_steps
from repro_torch.models import convert
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model

torch.set_num_threads(2)
F32 = dict(atol=2e-4, rtol=2e-4)


class FakeMesh:
    """The reference's stand-in mesh (``tests/test_sharding_spec.py``)."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


def meshes(**axes):
    """The port's abstract mesh and the reference's stand-in, alike."""
    return t_mesh.Mesh(tuple(axes.values()), tuple(axes)), FakeMesh(**axes)


MESH, RMESH = meshes(pod=2, data=4, model=8)


def fit_both(spec: tuple, shape, axes: dict = None):
    """``fit_spec`` in both packages; asserts they agree, returns the
    port's."""
    tm, rm = (MESH, RMESH) if axes is None else meshes(**axes)
    got = sharding.fit_spec(P(*spec), shape, tm)
    assert tuple(got) == tuple(r_shd.fit_spec(RP(*spec), shape, rm))
    return got


# ---------------------------------------------------------------------------
# twins of tests/test_sharding_spec.py: fit_spec
# ---------------------------------------------------------------------------
def test_indivisible_axis_falls_back_to_replicated():
    assert fit_both((None, "model", None), (2, 6, 32)) == P(None, None, None)


def test_divisible_axis_is_kept():
    assert fit_both((None, "model", None), (2, 16, 32)) \
        == P(None, "model", None)


def test_grouped_axes_keep_longest_valid_prefix():
    assert fit_both((("pod", "data"),), (16,)) == P(("pod", "data"))
    assert fit_both((("pod", "data"),), (6,)) == P("pod")
    assert fit_both((("pod", "data"),), (3,)) == P(None)


def test_prefix_stops_at_first_failing_axis():
    assert fit_both((("data", "pod"),), (2,)) == P(None)


def test_axes_absent_from_mesh_are_dropped():
    assert fit_both(("model", "data"), (8, 8), dict(data=4)) \
        == P(None, "data")


def test_axis_never_reused_across_dims():
    assert fit_both(("model", "model"), (8, 8)) == P("model", None)


def test_short_spec_padded_to_full_rank():
    spec = fit_both(("model",), (8, 4, 2))
    assert len(spec) == 3
    assert spec == P("model", None, None)


def test_size_one_dims_replicate():
    assert fit_both((("pod", "data"), "model"), (1, 1)) == P(None, None)


# ---------------------------------------------------------------------------
# twins: spec_for_axes / batch_spec / cache_specs
# ---------------------------------------------------------------------------
def test_spec_for_axes_applies_rules_and_shape():
    got = sharding.spec_for_axes(("embed", "heads", None), MESH,
                                 shape=(64, 16, 7))
    assert got == P(("pod", "data"), "model", None)
    assert tuple(got) == tuple(r_shd.spec_for_axes(
        ("embed", "heads", None), RMESH, shape=(64, 16, 7)))
    got = sharding.spec_for_axes(("embed",), MESH, shape=(64,),
                                 rules={"embed": ("model",)})
    assert got == P("model")
    assert tuple(got) == tuple(r_shd.spec_for_axes(
        ("embed",), RMESH, shape=(64,), rules={"embed": ("model",)}))


def test_batch_spec_groups_batch_axes():
    for axes, want in ((dict(pod=2, data=4, model=8), P(("pod", "data"))),
                       (dict(data=4, model=8), P("data")),
                       (dict(model=8), P())):
        tm, rm = meshes(**axes)
        assert sharding.batch_spec(tm) == want
        assert tuple(sharding.batch_spec(tm)) == tuple(r_shd.batch_spec(rm))


def test_cache_specs_seq_shard_switch():
    tcfg = t_configs.get("qwen2-7b")
    from repro_torch.models import smoke_config
    tcfg = smoke_config(tcfg)
    rcfg = r_config.smoke_config(r_configs.get("qwen2-7b"))
    tm, rm = meshes(data=2, model=2)
    head = sharding.cache_specs(tcfg, tm, batch=4, seq_len=32)
    seq = sharding.cache_specs(tcfg, tm, batch=4, seq_len=32,
                               seq_shard=True)
    # the port's cache keeps one unit cache per repeat: [stage][repeat]
    assert head[0][0]["0"]["self"]["k"] == P("data", "model", None, None)
    assert seq[0][1]["0"]["self"]["k"] == P("data", None, "model", None)
    r_head = r_shd.cache_specs(rcfg, rm, batch=4, seq_len=32)
    r_seq = r_shd.cache_specs(rcfg, rm, batch=4, seq_len=32,
                              seq_shard=True)
    assert tuple(head[0][0]["0"]["self"]["k"]) \
        == tuple(r_head[0]["0"]["self"]["k"])[1:]
    assert tuple(seq[0][0]["0"]["self"]["k"]) \
        == tuple(r_seq[0]["0"]["self"]["k"])[1:]
    odd = sharding.cache_specs(tcfg, tm, batch=3, seq_len=32)
    assert odd[0][0]["0"]["self"]["k"][0] is None


# ---------------------------------------------------------------------------
# twins: the single-device fallback (no ambient mesh)
# ---------------------------------------------------------------------------
def test_context_nesting_and_suspend():
    assert context.current_mesh() is None
    with context.use_mesh(MESH):
        assert context.current_mesh() is MESH
        assert context.data_axes() == ("pod", "data")
        with r_ctx.use_mesh(RMESH):
            assert r_ctx.data_axes() == context.data_axes()
        with context.suspend_mesh():
            assert context.current_mesh() is None
            assert context.data_axes() == ()
        assert context.current_mesh() is MESH
    assert context.current_mesh() is None


def test_constrain_is_identity_without_mesh():
    """Identity without a mesh, and under one too: the reference's GSPMD
    layout hints have no eager counterpart (see ``layers.constrain_btd``)."""
    from repro_torch.models import smoke_config
    cfg = smoke_config(t_configs.get("qwen2-7b"))
    x = torch.ones((2, 8, cfg.d_model))
    assert t_layers.constrain_btd(cfg, x) is x
    assert t_layers.constrain_inner(x, 2) is x
    with context.use_mesh(MESH):
        assert t_layers.constrain_btd(cfg, x) is x
        assert t_layers.constrain_inner(x, 2) is x


def test_seq_sharded_attention_falls_back_to_ref():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 4, 1, 16), (1, 2, 24, 16), (1, 2, 24, 16)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert context.current_mesh() is None
    out = decode_attn.seq_sharded_attention(tq, tk, tv, causal=True,
                                            window=8, q_offset=20)
    want = t_ref.attention_ref(tq, tk, tv, causal=True, window=8,
                               q_offset=20)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)
    # a mesh without a model axis, or with one of size 1, falls back too
    for tm in (meshes(data=4)[0], meshes(data=2, model=1)[0]):
        with context.use_mesh(tm):
            assert torch.equal(decode_attn.seq_sharded_attention(
                tq, tk, tv, causal=True, window=8, q_offset=20), out)
    r_out = r_attn.seq_sharded_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=8, q_offset=20)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), atol=1e-6)


def test_dp_grad_fn_falls_back_without_batch_axes():
    def loss_fn(params, batch):
        return torch.mean((params["w"] * batch["x"]) ** 2), {}

    def r_loss_fn(params, batch):
        return jnp.mean((params["w"] * batch["x"]) ** 2), {}

    fn = data_parallel.make_dp_grad_fn(loss_fn, t_mesh.Mesh((1,),
                                                            ("model",)))
    loss, grads = fn({"w": torch.arange(4.0)}, {"x": torch.ones(4)})
    r_fn = r_dp.make_dp_grad_fn(r_loss_fn, jax.make_mesh((1,), ("model",)))
    want_l, want_g = r_fn({"w": jnp.arange(4.0)}, {"x": jnp.ones((4,))})
    assert float(loss) == pytest.approx(float(want_l))
    np.testing.assert_allclose(grads["w"].numpy(), want_g["w"], rtol=1e-6)


# ---------------------------------------------------------------------------
# twins of tests/test_dist.py (single device): quantization
# ---------------------------------------------------------------------------
def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    q, s = compression.quantize(x)
    err = (compression.dequantize(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-7


def test_error_feedback_accumulates():
    x = torch.full((16,), 0.001)
    residual = torch.zeros(16)
    total = torch.zeros(16)
    rx, rres, rtot = jnp.full((16,), 0.001), jnp.zeros((16,)), \
        jnp.zeros((16,))
    for _ in range(30):
        q, s, residual = compression.quantize_with_feedback(x, residual)
        total = total + compression.dequantize(q, s)
        rq, rs, rres = r_comp.quantize_with_feedback(rx, rres)
        rtot = rtot + r_comp.dequantize(rq, rs)
    assert float((total / 30 - x).abs().max()) < 5e-4
    np.testing.assert_array_equal(total.numpy(), np.asarray(rtot))


def test_quantize_zero_input():
    q, s = compression.quantize(torch.zeros(8))
    assert float(compression.dequantize(q, s).abs().max()) == 0.0
    assert float(s) == float(r_comp.quantize(jnp.zeros((8,)))[1]) == 1.0


# ---------------------------------------------------------------------------
# the codec bit for bit
# ---------------------------------------------------------------------------
def _inputs(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    return {
        "normal": rng.standard_normal(1000).astype(np.float32),
        "small": (rng.uniform(-1, 1, (4, 8, 16)) * 1e-3).astype(np.float32),
        "large": (rng.standard_normal((3, 37)) * 1e4).astype(np.float32),
        "zeros": np.zeros((8,), np.float32),
        # amax 127 makes the scale exactly 1: ties at half a step
        "ties": np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5],
                         np.float32),
        "single": np.array([-3.25], np.float32),
    }[name]


CODEC = ["normal", "small", "large", "zeros", "ties", "single"]


@pytest.mark.parametrize("name", CODEC)
def test_quantize_equals_reference_bit_for_bit(name):
    x = _inputs(name)
    q, s = compression.quantize(torch.from_numpy(x))
    rq, rs = r_comp.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs, np.float32).tobytes()
    np.testing.assert_array_equal(
        compression.dequantize(q, s).numpy().view(np.uint32),
        np.asarray(r_comp.dequantize(rq, rs)).view(np.uint32))
    if name == "ties":
        assert q.tolist() == [127, 0, 2, 2, 0, -2, 126, -4]


@pytest.mark.parametrize("name", CODEC)
def test_quantize_with_feedback_equals_reference_bit_for_bit(name):
    x = _inputs(name)
    res = np.random.default_rng(8).standard_normal(x.shape).astype(
        np.float32) * np.float32(1e-3)
    t_res, r_res = torch.from_numpy(res), jnp.asarray(res)
    for _ in range(5):
        q, s, t_res = compression.quantize_with_feedback(
            torch.from_numpy(x), t_res)
        rq, rs, r_res = r_comp.quantize_with_feedback(jnp.asarray(x), r_res)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(t_res.numpy().view(np.uint32),
                                      np.asarray(r_res).view(np.uint32))


# ---------------------------------------------------------------------------
# the spec math over a seeded grid
# ---------------------------------------------------------------------------
GRID_MESHES = [dict(pod=2, data=4, model=8), dict(data=4, model=2),
               dict(model=8), dict(pod=2, data=2, model=2),
               dict(data=16, model=16)]
ENTRIES = [None, "pod", "data", "model", ("pod", "data"), ("data", "pod"),
           ("data", "model"), ("pod", "data", "model"), "absent"]
DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 256]


@pytest.mark.parametrize("axes", GRID_MESHES,
                         ids=lambda a: "x".join(map(str, a.values())))
def test_spec_math_equals_reference_over_a_grid(axes):
    tm, rm = meshes(**axes)
    rng = np.random.default_rng(len(axes) * 100 + sum(axes.values()))
    names = list(sharding.DEFAULT_RULES) + ["unknown"]
    for _ in range(200):
        rank = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice(DIMS)) for _ in range(rank))
        spec = tuple(ENTRIES[int(rng.integers(len(ENTRIES)))]
                     for _ in range(int(rng.integers(0, rank + 1))))
        assert tuple(sharding.fit_spec(P(*spec), shape, tm)) \
            == tuple(r_shd.fit_spec(RP(*spec), shape, rm)), (spec, shape)
        logical = tuple(names[int(rng.integers(len(names)))]
                        for _ in range(rank))
        rules = {"embed": ("model",), "vocab": ("pod", "data")} \
            if rng.integers(2) else None
        for kw in (dict(shape=shape), {}):
            assert tuple(sharding.spec_for_axes(
                logical, tm, rules=rules, **kw)) == tuple(
                r_shd.spec_for_axes(logical, rm, rules=rules, **kw))
    for b in range(1, 65):
        assert sharding.batch_entry(tm, b) == r_shd.batch_entry(rm, b)


# ---------------------------------------------------------------------------
# parameter and cache specs for the whole zoo
# ---------------------------------------------------------------------------
SPEC_MESHES = [dict(data=16, model=16), dict(pod=2, data=16, model=16),
               dict(pod=2, data=2, model=2), dict(data=2, model=4)]


def _port_leaves(tree, prefix=()):
    """(reference path, stacked?, spec) of a port spec tree: a stage's
    repeats (a list of unit dicts) share one reference path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, prefix + (k,))
    elif isinstance(tree, list) and tree and isinstance(tree[0], dict):
        for unit in tree:
            for key, _, s in _port_leaves(unit, prefix):
                yield key, True, s
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, prefix + (str(i),))
    else:
        assert isinstance(tree, P), tree
        yield "/".join(prefix), False, tree


def _ref_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, RP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def assert_specs_match(port_tree, ref_tree) -> int:
    """Every port spec equals the reference's at the same path, without
    the reference's leading (stacked repeats) entry where the port keeps
    a list; every reference leaf is reached.  Returns the leaf count."""
    want = _ref_leaves(ref_tree)
    seen = set()
    for key, stacked, spec in _port_leaves(port_tree):
        ref = want[key]
        if stacked:
            assert ref[0] is None, (key, ref)
            ref = ref[1:]
        assert tuple(spec) == ref, (key, spec, ref)
        seen.add(key)
    assert seen == set(want)
    return len(seen)


@pytest.mark.parametrize("arch", list(r_configs.ARCHS))
def test_param_and_cache_specs_equal_reference(arch):
    rcfg = r_configs.get(arch)
    tcfg = t_configs.get(arch)
    for axes in SPEC_MESHES:
        tm, rm = meshes(**axes)
        n = assert_specs_match(sharding.param_specs(tcfg, tm),
                               r_shd.param_specs(rcfg, rm))
        assert n > 10
        for batch, seq in ((128, 32768), (1, 524288), (3, 100)):
            for seq_shard in (False, True):
                assert_specs_match(
                    sharding.cache_specs(tcfg, tm, batch, seq,
                                         seq_shard=seq_shard),
                    r_shd.cache_specs(rcfg, rm, batch, seq,
                                      seq_shard=seq_shard))
        # placements: one per mesh axis, each axis on at most one dim
        for sh in t_layers.tree_leaves(sharding.param_shardings(tcfg, tm)):
            placements = sh.placements
            assert len(placements) == len(axes)
            for i, a in enumerate(tm.axis_names):
                dims = [d for d, e in enumerate(sh.spec)
                        if a in sharding.entry_axes(e)]
                if dims:
                    assert isinstance(placements[i], Shard)
                    assert placements[i].dim == dims[0]
                else:
                    assert isinstance(placements[i], Replicate)


def test_placements_refuse_an_entry_out_of_mesh_order():
    sh = sharding.NamedSharding(MESH, P(("data", "pod")))
    with pytest.raises(AssertionError, match="out of mesh order"):
        sh.placements


# ---------------------------------------------------------------------------
# the dry-run cells
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(r_configs.ARCHS))
def test_cells_and_batch_specs_equal_reference(arch):
    assert t_shapes.SHAPES == r_shapes.SHAPES
    assert t_shapes.SUBQUADRATIC == r_shapes.SUBQUADRATIC
    rcfg, tcfg = r_configs.get(arch), t_configs.get(arch)
    dtypes = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}
    for shape in r_shapes.SHAPES:
        assert t_shapes.cell_supported(arch, shape) \
            == r_shapes.cell_supported(arch, shape)
        tc, rc = t_shapes.make_cell(arch, shape), r_shapes.make_cell(
            arch, shape)
        assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
        assert tc.name == rc.name
        tb, rb = t_shapes.batch_specs(tcfg, tc), r_shapes.batch_specs(rcfg,
                                                                      rc)
        assert tb.keys() == rb.keys()
        for k in tb:
            assert tb[k].device.type == "meta"
            assert tuple(tb[k].shape) == tuple(rb[k].shape)
            assert tb[k].dtype == dtypes[rb[k].dtype.type]


# ---------------------------------------------------------------------------
# attn_impl="seq_shard" without a mesh
# ---------------------------------------------------------------------------
@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(r_model, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(t_model, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("arch", ["qwen2-7b", "h2o-danube-1.8b"])
def test_seq_shard_prefill_decode_match_reference(arch, f32):
    """A 40-token prompt (past h2o-danube's smoke window of 32), then three
    greedy decode steps through ``launch.steps``' prefill and decode steps,
    each one-row query through ``seq_sharded_attention``'s fallback."""
    rcfg = r_config.smoke_config(r_configs.get(arch), attn_impl="seq_shard")
    tcfg = convert.config_from_reference(rcfg)
    assert tcfg.attn_impl == "seq_shard"
    tree = convert.init_numpy(tcfg, seed=0)
    rparams = jax.tree.map(jnp.asarray, tree)
    tparams = convert.from_reference(tcfg, tree, device="cpu")
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 40))
    calls = []
    real = decode_attn.seq_sharded_attention

    def counted(*a, **k):
        calls.append(a[0].shape[2])
        return real(*a, **k)

    rlog, rc, _ = r_model.prefill(rcfg, rparams,
                                  jnp.asarray(prompt, jnp.int32), 64)
    tlog, tc = t_steps.make_prefill_step(tcfg, 64)(
        tparams, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **F32)
    decode = t_steps.make_decode_step(tcfg)
    pos = prompt.shape[1]
    decode_attn.seq_sharded_attention = counted
    try:
        for _ in range(3):
            nxt = np.array(jnp.argmax(rlog[:, -1], -1))[:, None]
            assert (nxt == torch.argmax(tlog[:, -1], -1)[:, None]
                    .numpy()).all()
            rlog, rc = r_model.decode_step(rcfg, rparams, rc,
                                           jnp.asarray(nxt, jnp.int32), pos)
            tlog, tc = decode(tparams, tc, torch.from_numpy(nxt), pos)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **F32)
            pos += 1
    finally:
        decode_attn.seq_sharded_attention = real
    assert calls == [1] * (3 * tcfg.n_layers)


# ---------------------------------------------------------------------------
# meshes, and the one-rank mesh of chip_smoke.py's phase 20
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_production_meshes_are_abstract_and_dev_meshes_need_a_group(
        tmp_path):
    single = t_mesh.make_production_mesh()
    multi = t_mesh.make_production_mesh(multi_pod=True)
    assert t_mesh.describe(single) == {"axis_names": ["data", "model"],
                                       "shape": [16, 16], "devices": 256}
    assert t_mesh.describe(multi) == {
        "axis_names": ["pod", "data", "model"], "shape": [2, 16, 16],
        "devices": 512}
    assert not multi.live
    with pytest.raises(RuntimeError, match="abstract"):
        multi.group("data")
    with pytest.raises(RuntimeError, match="process group"):
        t_mesh.make_dev_mesh((1, 1), device="cpu")
    with one_rank_group(tmp_path):
        with pytest.raises(ValueError, match="needs 4 ranks"):
            t_mesh.make_dev_mesh((2, 2), device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                t_mesh.make_dev_mesh((1,), ("data",))
        m = t_mesh.make_dev_mesh((1, 1, 1), ("pod", "data", "model"),
                                 device="cpu")
        assert m.live and m.coordinate() == {"pod": 0, "data": 0,
                                             "model": 0}
        for axes in (("pod",), ("data", "pod"), ("pod", "data", "model")):
            assert dist.get_world_size(m.group(axes)) == 1


def test_one_rank_dp_schedules_equal_the_plain_gradient(tmp_path):
    """flat and hier bit for bit, int8 within half a step per element
    (to float32 rounding; see the module docstring), on
    a (1, 1, 1) mesh; the loss alike.  The smoke h2o-danube-1.8b on the
    plain route with remat, as phase 20 runs it at full width."""
    from repro_torch.models import smoke_config
    cfg = smoke_config(t_configs.get("h2o-danube-1.8b"), attn_impl="torch")
    assert cfg.remat
    params = convert.from_reference(cfg, convert.init_numpy(cfg, 3),
                                    device="cpu")
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (4, 48)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    lf = functools.partial(t_model.loss_fn, cfg)
    (want_l, _), want = t_steps._value_and_grad(cfg, params, batch)
    stack = collectives.stack_repeats
    with one_rank_group(tmp_path):
        mesh = t_mesh.make_dev_mesh((1, 1, 1), ("pod", "data", "model"),
                                    device="cpu")
        with context.use_mesh(mesh):
            for kw in (dict(schedule="flat"), dict(schedule="hier"),
                       dict(schedule="hier", compress=True)):
                loss, grads = data_parallel.make_dp_grad_fn(
                    lf, mesh, **kw)(params, batch)
                assert torch.equal(loss, want_l)
                if kw.get("compress"):
                    # one scale per reference leaf: a stage's repeats
                    # quantized together, as the pod hop sends them
                    for g, w in zip(t_layers.tree_leaves(stack(grads)),
                                    t_layers.tree_leaves(stack(want))):
                        _, scale = compression.quantize(w)
                        assert float((g - w).abs().max()) \
                            <= float(scale) * (0.5 + 2 ** -16)
                    continue
                for g, w in zip(t_layers.tree_leaves(grads),
                                t_layers.tree_leaves(want)):
                    assert torch.equal(g, w)
