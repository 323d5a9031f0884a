"""The port's data pipeline, checkpoints and fault-tolerant trainer vs the
reference.

* ``TokenPipeline`` batches are bit-equal to the reference's, across
  ``state()`` / ``restore()``, host sharding and the prefetch thread.
* A checkpoint written by either package, a bfloat16 leaf included,
  restores in the other: same layout, same key strings, a stage's
  repeats stacked on the leading axis in the file.
* ``restore(shardings=...)`` and ``reshard`` place every leaf on a
  one-rank CPU mesh as a DTensor whose local shard is the leaf.
* ``FaultTolerantTrainer`` with an injected failure resumes from its last
  checkpoint with the pipeline's cursor restored, and ends bit for bit
  where an uninterrupted run ends (CPU, smoke size, plain route).
No tolerance anywhere: every comparison is exact.
"""
import contextlib
import dataclasses
import json
import os
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as r_configs
from repro.checkpoint import manager as r_ckpt
from repro.data import pipeline as r_pipe
from repro.ft import trainer as r_trainer
from repro.models import config as r_config
from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.data import pipeline as t_pipe
from repro_torch.dist import sharding as t_sharding
from repro_torch.ft import trainer as t_trainer
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import convert
from repro_torch.models import layers as t_layers
from repro_torch.optim import adamw as t_adamw

torch.set_num_threads(2)
DATA = [dict(vocab=256, seq_len=64, global_batch=4),
        dict(vocab=50_280, seq_len=128, global_batch=4, seed=3,
             mean_doc_len=64),
        dict(vocab=1000, seq_len=32, global_batch=6, num_hosts=2,
             host_id=1)]


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A live one-rank ``("data",)`` mesh on a gloo process group (a file
    store under ``tmp_path``), torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield t_mesh.make_dev_mesh((1,), ("data",), device="cpu")
    finally:
        dist.destroy_process_group()


def equal_batches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", DATA)
def test_pipeline_batches_equal_the_reference_across_restore(kw):
    t = t_pipe.TokenPipeline(t_pipe.DataConfig(**kw))
    r = r_pipe.TokenPipeline(r_pipe.DataConfig(**kw))
    for _ in range(3):
        equal_batches(t.next_batch(), r.next_batch())
    saved = t.state()
    assert json.loads(json.dumps(saved)) == saved == r.state()
    ahead = [t.next_batch() for _ in range(2)]
    fresh = t_pipe.TokenPipeline(t_pipe.DataConfig(**kw))
    fresh.restore(saved)
    r.restore(saved)
    for want in ahead:
        got = fresh.next_batch()
        equal_batches(got, want)
        equal_batches(got, r.next_batch())
    assert t_pipe.SyntheticCorpus(t.cfg).doc_length(7) == \
        r_pipe.SyntheticCorpus(r.cfg).doc_length(7)


def test_prefetcher_yields_the_pipeline_batches_in_order():
    """The prefetch thread keeps the batch it could not queue: a consumer
    slower than the queue's 0.2 s put timeout still sees every batch, in
    the reference pipeline's order."""
    kw = DATA[0]
    pre = t_pipe.make_pipeline(t_pipe.DataConfig(**kw), prefetch=2)
    r = r_pipe.TokenPipeline(r_pipe.DataConfig(**kw))
    try:
        for i in range(4):
            if i == 1:
                time.sleep(0.5)     # the queue stays full past a timeout
            equal_batches(next(pre), r.next_batch())
    finally:
        pre.close()
        pre.thread.join(timeout=5)
    assert not pre.thread.is_alive()
    assert isinstance(t_pipe.make_pipeline(t_pipe.DataConfig(**kw)),
                      t_pipe.TokenPipeline)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def host(t):
    """A port leaf as numpy, bfloat16 as ml_dtypes' (the reference's)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def stacked(tree):
    """A port parameter tree (numpy leaves) in the reference's layout: a
    stage's repeats, and the encoder's, stacked on a leading axis."""
    def walk(node):
        out = {k: walk(v) if k == "encoder" else v
               for k, v in node.items() if k != "stages"}
        out["stages"] = [jax.tree.map(lambda *xs: np.stack(xs), *stage)
                         for stage in node["stages"]]
        return out
    return walk(tree)


def reference_layout(state):
    """A port training state as the reference keeps it."""
    opt = state["opt"]
    return {"params": stacked(t_layers.tree_map(host, state["params"])),
            "opt": {"m": stacked(t_layers.tree_map(host, opt["m"])),
                    "v": stacked(t_layers.tree_map(host, opt["v"])),
                    "step": host(opt["step"])}}


def state_pair(arch: str = "whisper-small"):
    """The same training state in both layouts: smoke parameters (with an
    encoder) whose embedding is bfloat16, AdamW moments and the step."""
    rcfg = r_config.smoke_config(r_configs.get(arch))
    tcfg = convert.config_from_reference(rcfg)
    params = convert.from_reference(tcfg, convert.init_numpy(tcfg, seed=0),
                                    device="cpu")
    params["embed"] = params["embed"].to(torch.bfloat16)
    opt = t_adamw.adamw_init(params)
    opt["m"] = t_layers.tree_map(lambda p: p.float() * 0.5, params)
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    t_state = {"params": params, "opt": opt}
    return t_state, reference_layout(t_state)


def assert_same_tree(got, want):
    """Two trees in the reference's layout, exactly, dtypes included."""
    flat_w, tdef_w = jax.tree.flatten(want)
    flat_g, tdef_g = jax.tree.flatten(got)
    assert tdef_w == tdef_g
    for w, g in zip(flat_w, flat_g):
        w, g = np.asarray(w), np.asarray(g)
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8))


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    t_state, r_state = state_pair()
    t_ckpt.CheckpointManager(str(tmp_path)).save(
        3, t_state, extra={"data_state": {"next_doc": 5, "buffer": [1, 2]}})
    manifest = json.load(open(tmp_path / "step_00000003" / "manifest.json"))
    assert manifest["dtypes"]["params/embed"] == "bfloat16"
    assert "params/stages/0/0/xattn/wq" in manifest["keys"]
    assert "params/encoder/stages/0/0/attn/wq" in manifest["keys"]
    got, extra = r_ckpt.CheckpointManager(str(tmp_path)).restore(r_state)
    assert extra == {"data_state": {"next_doc": 5, "buffer": [1, 2]}}
    assert_same_tree(got, r_state)


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    t_state, r_state = state_pair()
    r_ckpt.CheckpointManager(str(tmp_path)).save(4, r_state,
                                                 extra={"step": 4})
    mgr = t_ckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 4
    target = t_layers.tree_map(lambda t: torch.empty_like(t, device="meta"),
                               t_state)
    got, extra = mgr.restore(target, device="cpu")
    assert extra == {"step": 4}
    assert got["params"]["embed"].dtype == torch.bfloat16
    for a, b in zip(t_layers.tree_leaves(got), t_layers.tree_leaves(t_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        bad = dict(target, opt=dict(target["opt"],
                                    step=torch.empty(2, device="meta")))
        mgr.restore(bad, device="cpu")
    # elastic resharding onto a one-rank CPU mesh (the 8-rank case is
    # tests/test_torch_dist_ranks.py): every leaf a DTensor whose local
    # shard is the whole leaf, bit for bit, the bfloat16 leaf included
    with one_rank_mesh(tmp_path) as mesh:
        shardings = t_layers.tree_map(
            lambda t: t_sharding.NamedSharding(mesh, t_sharding.fit_spec(
                t_sharding.P("data"), tuple(t.shape), mesh)), target)
        placed, extra = mgr.restore(target, shardings=shardings)
        assert extra == {"step": 4}
        for a, b in zip(t_layers.tree_leaves(placed),
                        t_layers.tree_leaves(t_state)):
            local = a.to_local()
            assert local.dtype == b.dtype and torch.equal(local, b)


def test_checkpoint_layout_atomic_latest_keep_and_async(tmp_path):
    mgr = t_ckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": [{"a": torch.arange(4.0)}, {"a": torch.arange(4.0) + 1}],
            "s": torch.tensor(0)}
    for step in (1, 2, 3):
        mgr.save(step, dict(tree, s=torch.tensor(step)), blocking=step != 2)
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000002",
                                            "step_00000003"]
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as data:
        np.testing.assert_array_equal(data["w/a"], [[0, 1, 2, 3],
                                                    [1, 2, 3, 4]])
    got, _ = mgr.restore(tree, step=2)
    assert int(got["s"]) == 2 and torch.equal(got["w"][1]["a"],
                                              tree["w"][1]["a"])
    with pytest.raises(FileNotFoundError):
        t_ckpt.CheckpointManager(str(tmp_path / "empty")).restore(tree)


# ---------------------------------------------------------------------------
# the fault-tolerant trainer
# ---------------------------------------------------------------------------
def run_trainer(tmp_path, fail_at=None, steps=6):
    cfg = dataclasses.replace(
        convert.config_from_reference(r_config.smoke_config(
            r_configs.get("qwen2-7b"))), attn_impl="torch")
    ocfg = t_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=steps)
    step = t_steps.make_train_step(cfg, ocfg)
    states = []

    def step_fn(state, batch):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        params, opt, m = step(state["params"], state["opt"], batch)
        states.append({"params": params, "opt": opt})
        return states[-1], {"loss": float(m["loss"]),
                            "grad_norm": float(m["grad_norm"])}

    fired = []

    def hook(s):
        if s == fail_at and not fired:
            fired.append(s)
            raise t_trainer.FailureInjected(f"injected at step {s}")
    pipe = t_pipe.TokenPipeline(t_pipe.DataConfig(vocab=cfg.vocab,
                                                  seq_len=16, global_batch=2))
    trainer = t_trainer.FaultTolerantTrainer(
        t_trainer.TrainerConfig(checkpoint_dir=str(tmp_path),
                                checkpoint_every=2),
        step_fn, pipe, t_train.make_state_fns(cfg, ocfg, seed=1,
                                              device="cpu"),
        failure_hook=hook)
    return trainer.run(steps), states[-1], pipe.state()


def test_trainer_restart_is_bit_exact(tmp_path):
    clean, final, cursor = run_trainer(tmp_path / "clean")
    failed, final_f, cursor_f = run_trainer(tmp_path / "failed", fail_at=3)
    assert clean["restarts"] == 0 and failed["restarts"] == 1
    assert failed["recovered_from"] == [2] and failed["final_step"] == 6
    assert [m["step"] for m in failed["metrics"]] == [0, 1, 2, 2, 3, 4, 5]
    by_step = {m["step"]: m for m in failed["metrics"]}
    for m in clean["metrics"]:
        assert by_step[m["step"]]["loss"] == m["loss"]
        assert by_step[m["step"]]["grad_norm"] == m["grad_norm"]
    assert cursor_f == cursor
    for a, b in zip(t_layers.tree_leaves(final_f),
                    t_layers.tree_leaves(final)):
        assert torch.equal(a, b)
    assert all(np.isfinite(m["loss"]) for m in clean["metrics"])


def test_straggler_detector_and_reshard_match_the_reference(tmp_path):
    t, r = t_trainer.StragglerDetector(4), r_trainer.StragglerDetector(4)
    rng = np.random.default_rng(0)
    for _ in range(20):
        host, dt = int(rng.integers(0, 4)), float(rng.uniform(0.5, 1.5))
        dt *= 3.0 if host == 2 else 1.0
        t.observe(host, dt)
        r.observe(host, dt)
    assert t.stragglers() == r.stragglers() == [2]
    # reshard onto a one-rank CPU mesh equals the reference's reshard onto
    # its one device (the 8-rank case is tests/test_torch_dist_ranks.py)
    tree = {"w": np.arange(12, dtype=np.float32).reshape(4, 3),
            "b": [np.ones(3, np.float32)]}
    with one_rank_mesh(tmp_path) as mesh:
        shd = {"w": t_sharding.NamedSharding(mesh, t_sharding.P("data")),
               "b": [t_sharding.NamedSharding(mesh, t_sharding.P())]}
        got = t_trainer.reshard(tree, shd)
    rmesh = jax.make_mesh((1,), ("data",))
    want = r_trainer.reshard(tree, {
        "w": jax.sharding.NamedSharding(rmesh, jax.sharding.PartitionSpec(
            "data")),
        "b": [jax.sharding.NamedSharding(rmesh,
                                         jax.sharding.PartitionSpec())]})
    np.testing.assert_array_equal(got["w"].to_local().numpy(), want["w"])
    np.testing.assert_array_equal(got["b"][0].to_local().numpy(),
                                  want["b"][0])
    assert t_trainer.reshard({}, {}) == {}
