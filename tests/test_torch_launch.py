"""The port's dry run (``repro_torch.launch``: ``make_case``, ``census``,
``dryrun``, ``probe``, ``report``) on the CPU, against the reference.

``tests/data/torch_port_dryrun_reference.json`` holds the reference's
``make_case`` lowered on a (2, 2, 2) mesh of 8 forced host devices, at
the smoke size of its own ``test_mini_dryrun_compiles_and_reports``
(``tests/make_torch_port_dryrun_reference.py`` writes it).  The port runs
the same cells on a fake (2, 2, 2) process group in this process (each
cell brings the group up and ends it), on fake CPU tensors: a CPU-only
PyTorch cannot carry fake CUDA tensors through autograd, and no count
depends on the device's name.
"""
from __future__ import annotations

import dataclasses
import json
import os

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import census, dryrun, probe, report, shapes, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.config import smoke_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "tests", "data",
                         "torch_port_dryrun_reference.json")
MESH = ((2, 2, 2), ("pod", "data", "model"))


def smoke_cell(arch: str, shape: str, seq: int = 64, batch: int = 8):
    cell = shapes.make_cell(arch, shape)
    return dataclasses.replace(cell, seq_len=seq,
                               global_batch=min(batch, cell.global_batch))


def smoke_record(arch: str, shape: str, **kw) -> dict:
    return dryrun.run_cell(arch, shape, True,
                           cfg=smoke_config(configs.get(arch)),
                           cell=smoke_cell(arch, shape), mesh_shape=MESH,
                           device="cpu", **kw)


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def records(reference):
    return {(c["arch"], c["shape"]): smoke_record(c["arch"], c["shape"])
            for c in reference["cells"]}


def _leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_leaves(v) for v in tree)
    return 1


CELLS = [("qwen2-7b", "train_4k"), ("qwen2-7b", "decode_32k"),
         ("mamba2-1.3b", "prefill_32k"), ("whisper-small", "train_4k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_reference(records, reference, arch, shape):
    """The local shards of every argument (parameters, optimizer state,
    caches, batch) are the reference's per-device buffers, byte for
    byte."""
    ref = next(c for c in reference["cells"]
               if (c["arch"], c["shape"]) == (arch, shape))
    rec = records[(arch, shape)]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_output_bytes_equal_reference_up_to_tuple_tables(records, reference,
                                                         arch, shape):
    """The outputs' local bytes equal the reference's up to what XLA adds
    to ``output_size_in_bytes`` beyond the buffers: a table of 8-byte
    buffer pointers per output tuple (at most one per output leaf and
    tuple, the port's leaves counted; the reference stacks a stage's
    repeats, so it has fewer)."""
    ref = next(c for c in reference["cells"]
               if (c["arch"], c["shape"]) == (arch, shape))
    rec = records[(arch, shape)]
    cfg = smoke_config(configs.get(arch))
    n_params = _leaves(steps.M.model_meta(cfg))
    leaves = {"train": 3 * n_params + 1 + 5, "prefill": 1 + 64,
              "decode": 1 + 64}[rec["kind"]]
    gap = ref["memory"]["output_size_in_bytes"] \
        - rec["memory"]["output_size_in_bytes"]
    assert 0 <= gap <= 8 * (leaves + 8), gap


@pytest.mark.parametrize("arch,shape", CELLS)
def test_flops_within_stated_ratio_of_reference(records, reference, arch,
                                                shape):
    """Per-device FLOPs against the reference's per-device HLO FLOPs
    (corrected for scan bodies): XLA counts every elementwise operation
    (adds, multiplies, exps, compares, selects) as FLOPs, the census the
    products only (``FlopCounterMode``'s formulas), so the port counts
    less, by most where elementwise work dominates (decode's one-row
    products): between 0.4 and 1.0 of the reference.  One exception, up
    to 1.2: mamba2's prefill, where the port runs the chunked scan's
    products and the reference a ``lax.scan`` over the tokens, whose body
    XLA counts once whatever the sequence's length."""
    ref = next(c for c in reference["cells"]
               if (c["arch"], c["shape"]) == (arch, shape))
    ratio = records[(arch, shape)]["flops"] / ref["flops"]
    high = 1.2 if (arch, shape) == ("mamba2-1.3b", "prefill_32k") else 1.0
    assert 0.4 <= ratio <= high, ratio


@pytest.mark.parametrize("arch,shape", CELLS)
def test_collective_kinds_against_reference(records, reference, arch,
                                            shape):
    """The kinds the census records are XLA's kinds, and the gathers the
    reference has are there.  They are not the same set (ROADMAP Queue
    3): DTensor reduces a pending sum into shards with reduce-scatter,
    which the reference's CPU HLO spells all-reduce + slice, and the
    reference's partitioner reshards with collective-permute and
    all-to-all, which the port's layouts do not need on this mesh."""
    from repro_torch.launch import hlo
    ref = next(c for c in reference["cells"]
               if (c["arch"], c["shape"]) == (arch, shape))
    got = set(records[(arch, shape)]["collectives"]["bytes_by_kind"])
    want = set(ref["collectives"]["bytes_by_kind"])
    assert got <= set(hlo.COLLECTIVES), got
    assert "all-gather" in got and "all-gather" in want
    assert got - want <= {"reduce-scatter"}, (got, want)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_probes_add_up_to_the_main_run(records, arch, shape):
    """Every layer runs in the main run, so nothing needs correcting:
    each stage's probe x reps x accum, plus loss_embed x accum, plus the
    encoder's probe x layers x accum, is the main run's FLOPs."""
    rec = records[(arch, shape)]
    cfg = dataclasses.replace(
        smoke_config(configs.get(arch)),
        max_seq=max(128, rec["seq_len"]))
    assert rec["flops"] == rec["flops_raw"]
    assert probe.probe_total(cfg, rec["probes"], rec["accum_steps"]) == \
        rec["flops_raw"]


def test_report_tables_render(records):
    recs = list(records.values()) + [
        {"arch": "qwen2-7b", "shape": "long_500k", "mesh": "multi",
         "status": "skipped", "reason": "skip: pure full attention"}]
    for r in records.values():
        r["mesh"] = "single"
    table = report.dryrun_table(recs)
    roof = report.roofline_table(recs, "single")
    summ = report.summary(recs)
    assert table.count("| ok |") == len(records) and "SKIP" in table
    assert roof.count("\n") == len(records) + 1
    assert f"{len(records)} ok / 1 skipped / 0 errors" in summ


class _Shapes(census.Census):
    """The census, also counting the shape of every tensor its local ops
    make."""

    def __init__(self):
        super().__init__()
        self.shapes: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and not self._in_prop:
            self.shapes.update(tuple(t.shape) for t in census._tensors(out))
        return out


@pytest.mark.parametrize("tied", [False, True])
def test_train_step_keeps_the_vocabulary_split(records, tied):
    """qwen2-7b ``train_4k`` at smoke size (vocab 256 over a ``model``
    axis of 2, d 64): as in the reference's program, no rank holds the
    whole vocabulary.  No collective's operand and no tensor that a local
    op makes is (256, 64) or (64, 256), and no collective moves the
    whole float32 table (65 536 bytes); the record's collective total is
    below the 1 450 672 bytes of the loss that gathered the unembedding
    whole and the embedding whose backward made the whole table's
    gradient.  (Element counts alone do not tell: a chunk of logits over
    a rank's 128 columns, (2, 64, 128), has as many elements as the
    table, as the reference's f32[128,128] has.)"""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist import context
    arch, shape = "qwen2-7b", "train_4k"
    cfg = smoke_config(configs.get(arch), tie_embeddings=tied)
    v, d = cfg.vocab, cfg.d_model
    mesh = mesh_mod.make_fake_mesh(True, device="cpu", shape=MESH[0],
                                   axes=MESH[1])
    try:
        case = steps.make_case(cfg, smoke_cell(arch, shape), mesh,
                               device="cpu")
        with case.mode, context.use_mesh(mesh), implicit_replication(), \
                _Shapes() as c:
            case.fn(*case.args)
    finally:
        mesh_mod.destroy_fake_mesh()
    whole = {(v, d), (d, v)}
    assert not [op for op in c.ops if tuple(op["shape"]) in whole
                or op["bytes"] == v * d * 4], c.ops
    assert not c.shapes & whole, c.shapes & whole
    assert c.collectives()["total_bytes"] < 1_450_672
    assert records[(arch, shape)]["collectives"]["total_bytes"] < 1_450_672


def test_fake_counts_equal_real_counts():
    """The same case on real CPU tensors of the same local shapes counts
    what the fake one counts: FLOPs, bytes accessed, collectives and
    argument bytes."""
    arch, shape = "qwen2-7b", "decode_32k"
    cfg = smoke_config(configs.get(arch))
    cell = smoke_cell(arch, shape)
    mesh = mesh_mod.make_fake_mesh(True, device="cpu", shape=MESH[0],
                                   axes=MESH[1])
    try:
        fake, _ = dryrun.run_case(
            steps.make_case(cfg, cell, mesh, device="cpu"), mesh)
        gen = torch.Generator().manual_seed(0)
        real_case = steps.make_case(cfg, cell, mesh, device="cpu",
                                    fill=steps.real_fill(gen))
        real, _ = dryrun.run_case(real_case, mesh)
    finally:
        mesh_mod.destroy_fake_mesh()
    for key in ("flops", "bytes_accessed", "collectives"):
        assert fake[key] == real[key], key
    assert fake["memory"]["argument_size_in_bytes"] == \
        real["memory"]["argument_size_in_bytes"]


def test_rank_zero_stands_for_every_rank():
    """``fit_spec`` shards only evenly divisible dimensions, so every rank
    holds shards of rank 0's shapes, and every rank runs the same program:
    the case's local shapes, FLOPs, bytes accessed and temp at ranks 0 and
    7 (the last on every axis) of the (2, 2, 2) mesh are the same.  Three
    query heads do not divide the model axis of 2, so attention splits its
    query rows (``seq``), where the last rank's causal rows see the most
    keys."""
    arch = "qwen2-7b"
    cfg = smoke_config(configs.get(arch), n_heads=3, n_kv_heads=1)
    cell = smoke_cell(arch, "train_4k")
    by_rank = []
    for rank in (0, 7):
        mesh = mesh_mod.make_fake_mesh(True, rank, device="cpu",
                                       shape=MESH[0], axes=MESH[1])
        try:
            case = steps.make_case(cfg, cell, mesh, device="cpu")
            rec, _ = dryrun.run_case(case, mesh)
            by_rank.append(([tuple(t.to_local().shape) for t in
                             steps.L.tree_leaves(case.args)],
                            rec["flops"], rec["bytes_accessed"],
                            rec["memory"]["temp_size_in_bytes"]))
            assert mesh.coordinate() == dict(zip(MESH[1], [
                rank // 4, rank // 2 % 2, rank % 2]))
        finally:
            mesh_mod.destroy_fake_mesh()
    assert by_rank[0] == by_rank[1]


def test_long_context_decode_rings_and_gathers_no_cache():
    """h2o-danube's ``long_500k`` (``attn_impl="seq_shard"``): the cache
    stays sharded by sequence: its chunks go round the ring
    (``collective-permute`` of one chunk, in the ring's float32) and no
    all-gather takes a cache chunk."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist import context
    from repro_torch.launch import census
    arch, shape = "h2o-danube-1.8b", "long_500k"
    cfg = smoke_config(configs.get(arch))
    mesh = mesh_mod.make_fake_mesh(True, device="cpu", shape=MESH[0],
                                   axes=MESH[1])
    try:
        case = steps.make_case(cfg, smoke_cell(arch, shape), mesh,
                               device="cpu")
        with case.mode, context.use_mesh(mesh), implicit_replication(), \
                census.Census() as c:
            case.fn(*case.args)
    finally:
        mesh_mod.destroy_fake_mesh()
    chunk = [1, cfg.n_kv_heads, 64 // 2, cfg.hd]   # batch 1, 2 model ranks
    kinds = {(op["kind"], tuple(op["shape"])) for op in c.ops}
    assert ("collective-permute", tuple(chunk)) in kinds, kinds
    assert not any(k == "all-gather" and list(sh[-2:]) == chunk[-2:]
                   and len(sh) == 4 for k, sh in kinds), kinds


def test_layout_hints_are_identities_on_plain_tensors():
    from repro_torch.models import layers as L
    cfg = smoke_config(configs.get("qwen2-7b"))
    x = torch.randn(2, 8, 64)
    assert L.constrain_btd(cfg, x) is x
    assert L.constrain_inner(x, 2) is x


@pytest.mark.parametrize("act_shard,placements", [
    ("model_d", "(Shard(dim=0), Shard(dim=0), Shard(dim=2))"),
    ("model_seq", "(Shard(dim=0), Shard(dim=0), Shard(dim=1))"),
    ("none", "(Shard(dim=0), Shard(dim=0), Replicate())")])
def test_layout_hints_redistribute_dtensors(act_shard, placements):
    """Under a live mesh ``constrain_btd`` lays a DTensor out as the
    reference's ``act_shard`` spec says, and the FSDP gather keeps only
    the ``model`` axis of a parameter's placements."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.dist import context, sharding
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = dataclasses.replace(smoke_config(configs.get("qwen2-7b")),
                              act_shard=act_shard)
    mesh = mesh_mod.make_fake_mesh(True, device="cpu", shape=MESH[0],
                                   axes=MESH[1])
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), \
                context.use_mesh(mesh):
            x = DTensor.from_local(torch.empty(8, 64, 64), mesh.device_mesh,
                                   [Replicate()] * 3, run_check=False)
            y = L.constrain_btd(cfg, x)
            assert str(tuple(y.placements)) == placements
            ns = sharding.param_shardings(cfg, mesh)["stages"][0][0]["0"][
                "mlp"]["wg"]
            w = steps._placed(torch.empty(64, 128, device="meta"), ns,
                              "cpu", steps._empty)
            g = M.gathered(w)
            assert str(tuple(g.placements)) == \
                "(Replicate(), Replicate(), Shard(dim=1))"
    finally:
        mesh_mod.destroy_fake_mesh()


def test_custom_ops_fake_implementations_shapes_and_flops():
    """The kernels' custom ops trace on fake tensors: their fake
    implementations give the real outputs' shapes and dtypes, and their
    FLOP formulas count what ``chip_smoke.py``'s bounds count."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    q_real = torch.randn(2, 8, 96, 32).to(torch.bfloat16)
    k_real = torch.randn(2, 2, 160, 32).to(torch.bfloat16)
    want = fa.plain(q_real, k_real, k_real, causal=True, window=48)
    x_real = torch.randn(2, 4, 128, 16).to(torch.bfloat16)
    b_real = torch.randn(2, 1, 128, 16).to(torch.bfloat16)
    y_want = ss.plain(x_real, torch.rand(2, 4, 128), -torch.rand(4), b_real,
                      b_real, chunk=64)
    with FakeTensorMode() as mode:
        q, k = mode.from_tensor(q_real), mode.from_tensor(k_real)
        with FlopCounterMode(display=False) as fc:
            out = torch.ops.repro_torch.flash_attention(q, k, k, True, 48,
                                                        0.17)
        assert out.shape == want.shape and out.dtype == want.dtype
        assert fc.get_total_flops() == fa.flops(q.shape, k.shape, True, 48)
        assert fa.visible_pairs(96, 160, True, 48) == 96 * 48
        x, b = mode.from_tensor(x_real), mode.from_tensor(b_real)
        dt, a = torch.empty(2, 4, 128), torch.empty(4)
        with FlopCounterMode(display=False) as fc:
            y = torch.ops.repro_torch.ssd_scan(x, dt, a, b, b, 64, 0)
        assert y.shape == y_want.shape and y.dtype == y_want.dtype
        tri = 64 * 65 // 2
        assert fc.get_total_flops() == 2 * 4 * 2 * 2 * (
            tri * 16 + tri * 16 + 2 * 64 * 16 * 16)


def test_custom_ops_shard_over_dtensors():
    """The sharding rules: batch-split and head-split inputs go through
    the ops locally (no collective), the output split the same way."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    import repro_torch.kernels.flash_attention  # noqa: F401
    import repro_torch.kernels.ssd_scan  # noqa: F401
    from repro_torch.launch import census
    mesh = mesh_mod.make_fake_mesh(True, device="cpu", shape=MESH[0],
                                   axes=MESH[1])
    try:
        dm = mesh.device_mesh
        with FakeTensorMode(), census.Census() as c:
            def dt(shape, placements):
                return DTensor.from_local(torch.empty(shape), dm,
                                          placements, run_check=False)
            q = dt((2, 4, 32, 16), [Shard(0), Replicate(), Shard(1)])
            k = dt((2, 1, 32, 16), [Shard(0), Replicate(), Shard(1)])
            out = torch.ops.repro_torch.flash_attention(q, k, k, True, 0,
                                                        0.25)
            assert tuple(out.placements) == tuple(q.placements)
            assert tuple(out.shape) == (4, 8, 32, 16)
            x = dt((4, 2, 64, 8), [Replicate(), Shard(0), Shard(1)])
            dts = dt((4, 2, 64), [Replicate(), Shard(0), Shard(1)])
            a = dt((2,), [Replicate(), Replicate(), Shard(0)])
            b = dt((4, 1, 64, 8), [Replicate(), Shard(0), Replicate()])
            y = torch.ops.repro_torch.ssd_scan(x, dts, a, b, b, 64, 0)
            assert tuple(y.placements) == tuple(x.placements)
        assert c.ops == []
    finally:
        mesh_mod.destroy_fake_mesh()


def test_flash_rule_splits_heads_only_where_both_divide():
    """Three K/V heads do not split evenly over the model axis of 2 (six
    query heads do): the flash rule then offers no head split, so the
    heads are gathered and the op runs on all of them, never pairing
    query heads with the wrong K/V heads."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    import repro_torch.kernels.flash_attention  # noqa: F401
    from repro_torch.launch import census
    mesh = mesh_mod.make_fake_mesh(True, device="cpu", shape=MESH[0],
                                   axes=MESH[1])
    try:
        dm = mesh.device_mesh
        place = [Shard(0), Replicate(), Shard(1)]
        with FakeTensorMode(), census.Census() as c:
            q = DTensor.from_local(torch.empty(2, 3, 32, 16), dm, place,
                                   run_check=False)
            k = DTensor.from_local(torch.empty(2, 2, 32, 16), dm, place,
                                   run_check=False, shape=(4, 3, 32, 16),
                                   stride=(1536, 512, 16, 1))
            out = torch.ops.repro_torch.flash_attention(q, k, k, True, 0,
                                                        0.25)
            assert out.placements[2] != Shard(1)
            assert tuple(out.to_local().shape)[1] == 6
        assert any(op["kind"] == "all-gather" for op in c.ops), c.ops
    finally:
        mesh_mod.destroy_fake_mesh()
