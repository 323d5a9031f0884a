"""``launch.steps.make_case``'s training step on real tensors on 8 gloo CPU
ranks, a (2, 2, 2) ``("pod", "data", "model")`` mesh, against the same
step with no mesh.

One subprocess runs this file as a script: it starts 8 ranks
(``torch.multiprocessing``, a gloo process group over a file store), each
of which builds the smoke qwen2-7b ``train_4k`` case (8 sequences of 64
tokens) on the live mesh, places the parameters that ``convert.init_numpy``
draws from a seed on ``param_shardings`` (the vocabulary split over
``model``, the width over the batch axes), runs the case's step once
(``make_train_step``, which the case wraps, asked to keep its
gradients: FSDP gathers, the blocks on their shards, the loss on each
rank's slice of the vocabulary, AdamW in place) and the same step on
whole tensors with no mesh, in float32 compute, and reports the loss's
relative error and each gradient leaf's largest error beside the leaf's
largest magnitude; rank 0 writes the reports to a JSON file.  Bounds:
the loss within 1e-5 relative; every gradient leaf within 1e-5 of its
own largest magnitude plus 1e-7, and within 1e-4 per element (float32
sums in another order; the errors are about 1e-8).
Two variants: the configuration as published (a separate unembedding)
and the same with the embedding tied (``unembed`` = ``embed``.T).

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_train_mesh.py`` (about 30 s, most of it the 8 ranks'
start-up).
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
MESH = ((2, 2, 2), ("pod", "data", "model"))
VARIANTS = ("untied", "tied")
SEED = 41


def _step(tied: bool, mesh) -> dict:
    import dataclasses
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.dist import context, sharding
    from repro_torch.launch import shapes, steps
    from repro_torch.launch.multicard import leaf_errors
    from repro_torch.models import convert, smoke_config
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = smoke_config(configs.get("qwen2-7b"), tie_embeddings=tied)
    cell = dataclasses.replace(shapes.make_cell("qwen2-7b", "train_4k"),
                               seq_len=64, global_batch=8)
    seqs = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (8, 65)).astype(np.int32)
    host_batch = {"tokens": torch.from_numpy(seqs[:, :-1].copy()),
                  "labels": torch.from_numpy(seqs[:, 1:].copy())}
    compute = M.COMPUTE_DTYPE
    M.COMPUTE_DTYPE = torch.float32
    try:
        case = steps.make_case(cfg, cell, mesh, device="cpu",
                               fill=steps._zeros)
        step = steps.make_train_step(
            case.cfg, AdamWConfig(),
            accum_steps=steps.accum_for(case.cfg, cell), keep_grads=True)

        def host_params():
            return convert.from_reference(
                case.cfg, convert.init_numpy(case.cfg, SEED), device="cpu")
        params = tree_map(sharding.place, host_params(),
                          sharding.param_shardings(case.cfg, mesh))
        batch = {k: sharding.place(v, ns) for (k, v), ns in zip(
            host_batch.items(),
            steps._batch_shardings(mesh, host_batch).values())}
        with context.use_mesh(mesh), implicit_replication():
            _, _, metrics = step(params, case.args[1], batch)
        loss = metrics["loss"].full_tensor()
        vocab = tuple(params["embed"].to_local().shape)
        plain = host_params()
        _, _, want = step(plain, adamw_init(plain), host_batch)
    finally:
        M.COMPUTE_DTYPE = compute
    return {"loss": float(loss), "want_loss": float(want["loss"]),
            "loss_rel": abs(float(loss) - float(want["loss"]))
            / abs(float(want["loss"])),
            "grad_errs": leaf_errors(metrics["grads"], want["grads"]),
            "embed_local_shape": list(vocab)}


def _rank(rank: int, init: str, out_path: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    mesh = mesh_mod.make_dev_mesh(*MESH, device="cpu")
    report = {"rank": rank,
              **{v: _step(v == "tied", mesh) for v in VARIANTS}}
    reports = [None] * WORLD
    dist.all_gather_object(reports, report)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(reports, f)
    dist.barrier()
    dist.destroy_process_group()


def main(out_path: str) -> None:
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(f"file://{tmp}/store", out_path),
                 nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1])


# ---------------------------------------------------------------------------
# the tests (one subprocess start for the whole file)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_mesh") / "reports.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out) as f:
        reps = json.load(f)
    assert [r["rank"] for r in reps] == list(range(WORLD))
    return reps


@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_train_step_loss_equals_no_mesh(reports, variant):
    for r in reports:
        d = r[variant]
        assert d["loss_rel"] < 1e-5, d
    assert len({r[variant]["loss"] for r in reports}) == 1


@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_train_step_grads_equal_no_mesh(reports, variant):
    """Every gradient leaf within 1e-5 of its own largest magnitude plus
    1e-7, and within 1e-4, of the no-mesh step's (float32 sums over other
    row and vocab blocks; the largest gradient is about 0.03, the errors
    about 1e-8), the vocabulary split over ``model`` (each rank 128 of
    the 256 rows of the embedding, 16 of its 64 columns)."""
    for r in reports:
        d = r[variant]
        assert d["grad_errs"], d
        for name, err, scale in d["grad_errs"]:
            assert err <= 1e-5 * scale + 1e-7 and err < 1e-4, \
                (r["rank"], name, err, scale)
        assert d["embed_local_shape"] == [128, 16], d
