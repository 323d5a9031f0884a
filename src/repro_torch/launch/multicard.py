"""The distribution layer across four ranks, one process per rank (no twin
in the reference, whose multi-device proofs run on forced host devices).

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.multicard
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.multicard \\
        --device cpu

On the cards (the default) each rank takes the card of its local rank and
the ranks talk over NCCL, at the published widths; ``--device cpu`` runs
the same checks over gloo on the CPU at smoke sizes
(``tests/test_torch_multicard.py`` spawns it so).  Every check runs on
every rank, and every rank holds every rank's results; rank 0 prints one
JSON line per check (and writes it to ``--out``), then a last line with
``"ok"``.  A check that fails raises on every rank, and the script exits
non-zero; nothing is caught and passed over.

The checks:

* ``dp_grads``: ``dist.make_dp_grad_fn`` under ``flat``, ``hier`` and
  ``hier`` + int8 on a (2, 2) ``("pod", "data")`` mesh (h2o-danube-1.8b
  at full depth, float32 compute, each rank a quarter of the rows), held
  to the gloo tests' bounds: ``flat`` and ``hier`` within 1e-6 of each
  other and 1e-4 of the no-mesh gradient per element, the losses within
  1e-5 relative; int8 within half the pods' summed scales (one per
  reference leaf, a stage's repeats stacked) over the ranks, plus 1e-6;
* ``ring_decode``: the ``seq_shard`` ring over a ``model`` axis of 4 at
  h2o-danube-1.8b's width: ``seq_sharded_attention`` on each rank's
  chunk of a cache within 1e-4 of ``kernels.ref.attention_ref`` on the
  whole cache, with and without the sliding window; then the model
  prefilled under the mesh (each rank only its chunk of every cache)
  and decoded by the owning step (the rows written in place, the same
  storage back), float32 compute, its logits within 1e-4 of the no-mesh
  decode's and the same greedy tokens;
* ``moe``: one MoE block at phi3.5-moe's width on a ``data`` axis of 4,
  its capacity factor cut to 0.5 so that tokens drop (the drop count is
  asserted positive), float32, held to the no-mesh block: outputs within
  1e-4, the auxiliary loss within 1e-6;
* ``reshard``: ``ft.trainer.reshard`` and ``CheckpointManager.restore(
  shardings=)`` of h2o-danube-1.8b's parameters onto ``param_shardings``
  of a (2, 2) ``("data", "model")`` mesh, every local shard equal bit
  for bit to its slice of the whole leaf;
* ``train_step``: ``launch.steps.make_case``'s training step on real
  tensors on that mesh (h2o-danube-1.8b at 4 layers, its vocabulary
  split over ``model``, float32 compute, 8 x 512 tokens; the smoke
  config, 8 x 16, on the CPU) against the same step with no mesh on
  one card: the loss within 1e-5 relative, every gradient leaf within
  1e-5 of its own largest magnitude plus 1e-7, and within 1e-4 per
  element; and no collective in its census has an operand of the whole
  vocabulary's V x d elements;
* ``census``: the dry run's census of real steps on that mesh (qwen2-7b
  ``decode_32k`` and mamba2-1.3b ``train_4k``, the batch cut to 4 on
  the cards), its collective bytes by kind equal on every rank and equal
  to the census of the same case on a 4-rank fake mesh
  (``launch.mesh.make_fake_mesh``), which rank 0 runs in a fresh
  process once the real group is down.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import datetime
import functools
import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import time

import torch
import torch.distributed as dist

WORLD = 4
SEED = 31
# full width on the cards (depth cut where a check needs no more), smoke
# sizes on the CPU
SIZES = {
    "cuda": dict(grad_rows=8, grad_seq=512, attn_rows=2, attn_seq=32768,
                 layers=4, prompt=64, max_seq=128, moe_rows=(8, 512),
                 census_batch=4, census_seq=None),
    "cpu": dict(grad_rows=8, grad_seq=16, attn_rows=2, attn_seq=64,
                layers=None, prompt=40, max_seq=64, moe_rows=(8, 16),
                census_batch=8, census_seq=64),
}
NEW_TOKENS = 3
MOE_CAPACITY = 0.5
CENSUS_CELLS = (("qwen2-7b", "decode_32k"), ("mamba2-1.3b", "train_4k"))


def _config(arch: str, device: str, layers=None, **overrides):
    """``arch`` at its published width on the cards (``layers`` of it when
    given), its smoke config on the CPU."""
    from repro_torch import configs
    from repro_torch.models import smoke_config
    cfg = configs.get(arch)
    if device == "cpu":
        return smoke_config(cfg, **overrides)
    if layers is not None:
        (unit, _), = cfg.stages
        overrides.update(n_layers=layers * len(unit),
                         stages=((unit, layers),))
    return dataclasses.replace(cfg, **overrides)


def _generator(device: str, offset: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SEED + offset)


@contextlib.contextmanager
def _float32():
    """The models' compute dtype set to float32 (the gloo tests' way of
    holding sums, not roundings)."""
    from repro_torch.models import model as M
    old, M.COMPUTE_DTYPE = M.COMPUTE_DTYPE, torch.float32
    try:
        yield
    finally:
        M.COMPUTE_DTYPE = old


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _max_err(a, b) -> float:
    from repro_torch.models.layers import tree_leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def leaf_errors(got, want, path: str = "") -> list:
    """Leaf by leaf of ``want`` (``got`` the same tree, its leaves tensors
    or DTensors): ``[path, max |got - want|, max |want|]``, so that each
    error is read against its own leaf's scale."""
    if isinstance(want, dict):
        return [e for k in want
                for e in leaf_errors(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        return [e for i, (g, w) in enumerate(zip(got, want))
                for e in leaf_errors(g, w, f"{path}/{i}")]
    g = got.full_tensor() if hasattr(got, "full_tensor") else got
    want = want.float()
    return [[path, float((g.float() - want).abs().max()),
             float(want.abs().max())]]


def check_dp_grads(device: str, size: dict) -> dict:
    from repro_torch.dist import (collectives, compression, data_parallel,
                                  sharding)
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_leaves, tree_map
    mesh = mesh_mod.make_dev_mesh((2, 2), ("pod", "data"), device=device)
    cfg = _config("h2o-danube-1.8b", device, attn_impl="torch",
                  act_shard="none")
    params = M.init_params(cfg, _generator(device, 0), device)
    seqs = torch.randint(0, cfg.vocab, (size["grad_rows"],
                                        size["grad_seq"] + 1),
                         generator=_generator(device, 1), device=device)
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    lf = functools.partial(M.loss_fn, cfg)
    out, secs = {}, {}
    with _float32():
        (want_loss, _), want = data_parallel.value_and_grad(lf)(params,
                                                                batch)
        runs = {}
        for name, kw in (("flat", dict(schedule="flat")),
                         ("hier", dict(schedule="hier")),
                         ("int8", dict(schedule="hier", compress=True))):
            fn = data_parallel.make_dp_grad_fn(lf, mesh, **kw)
            _sync(device)
            t0 = time.perf_counter()
            runs[name] = fn(params, batch)
            _sync(device)
            secs[name] = time.perf_counter() - t0
        # the int8 bound: each pod's inner-summed gradient is quantized
        # once, with an error of at most half its scale
        local = tree_map(lambda t: sharding.local_rows(
            mesh, t, ("pod", "data")), batch)
        _, g = data_parallel.value_and_grad(lf)(params, local)
        # one scale per reference leaf (a stage's repeats stacked), as
        # the pod hop sends them
        scales = tree_map(lambda t: collectives.all_gather(
            compression.quantize(collectives.psum(
                t, mesh.group("data")))[1].reshape(1), mesh.group("pod")),
            collectives.stack_repeats(g))
    flat, hier, int8 = (runs[k][1] for k in ("flat", "hier", "int8"))
    out["flat_vs_hier"] = _max_err(flat, hier)
    out["flat_vs_no_mesh"] = _max_err(flat, want)
    out["hier_vs_no_mesh"] = _max_err(hier, want)
    out["loss_rel"] = max(abs(float(runs[k][0]) - float(want_loss))
                          / abs(float(want_loss)) for k in runs)
    stack = collectives.stack_repeats
    out["int8_excess"] = max(
        float(((a - b).abs() - (s.sum() / 2 / WORLD + 1e-6)).max())
        for a, b, s in zip(tree_leaves(stack(int8)), tree_leaves(stack(flat)),
                           tree_leaves(scales)))
    out["seconds"] = secs
    out["ok"] = (out["flat_vs_hier"] < 1e-6 and out["flat_vs_no_mesh"] < 1e-4
                 and out["hier_vs_no_mesh"] < 1e-4 and out["loss_rel"] < 1e-5
                 and out["int8_excess"] <= 0.0)
    out["config"] = f"{cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}), " \
        f"{size['grad_rows']} x {size['grad_seq']} tokens, float32 compute"
    return out


def check_ring_decode(device: str, size: dict) -> dict:
    from repro_torch.dist import context, decode_attn
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_leaves
    mesh = mesh_mod.make_dev_mesh((WORLD,), ("model",), device=device)
    rank = mesh.coordinate()["model"]
    cfg = _config("h2o-danube-1.8b", device, layers=size["layers"],
                  attn_impl="seq_shard", act_shard="none")
    out: dict = {}
    # the op: one query row against a whole cache, each rank its chunk
    gen = _generator(device, 2)
    b, s = size["attn_rows"], size["attn_seq"]
    q = torch.randn((b, cfg.n_heads, 1, cfg.hd), generator=gen,
                    device=device)
    k, v = (torch.randn((b, cfg.n_kv_heads, s, cfg.hd), generator=gen,
                        device=device) for _ in range(2))
    chunk = s // WORLD
    kc, vc = (t[:, :, rank * chunk:(rank + 1) * chunk] for t in (k, v))
    errs = {}
    for window in (cfg.sliding_window, None):
        with context.use_mesh(mesh):
            got = decode_attn.seq_sharded_attention(
                q, kc, vc, causal=True, window=window, q_offset=s - 1)
        want = kref.attention_ref(q, k, v, causal=True, window=window,
                                  q_offset=s - 1)
        errs[str(window)] = float((got - want).abs().max())
    out["attention_vs_ref"] = errs
    # the model: prefill under the mesh (each rank its chunks), then the
    # owning decode step, against the same model without a mesh
    params = M.init_params(cfg, _generator(device, 3), device)
    prompt = torch.randint(0, cfg.vocab, (2, size["prompt"]),
                           generator=_generator(device, 4), device=device)
    runs, in_place, shapes = {}, [], None
    with _float32():
        for name in ("mesh", "none"):
            with context.use_mesh(mesh if name == "mesh" else None):
                logits, caches, _ = M.prefill(cfg, params, prompt,
                                              size["max_seq"])
                if name == "mesh":
                    shapes = list(caches[0][0]["0"]["self"]["k"].shape)
                pos, toks, steps = size["prompt"], [], []
                for _ in range(NEW_TOKENS):
                    nxt = torch.argmax(logits[:, -1], -1)[:, None]
                    toks.append(nxt)
                    ptrs = [t.untyped_storage().data_ptr()
                            for t in tree_leaves(caches)]
                    logits, caches = M.decode_step(cfg, params, caches, nxt,
                                                   pos, donate=True)
                    in_place.append(ptrs == [
                        t.untyped_storage().data_ptr()
                        for t in tree_leaves(caches)])
                    steps.append(logits)
                    pos += 1
            runs[name] = (torch.cat(toks, 1), torch.stack(steps))
    out["logit_err"] = float((runs["mesh"][1] - runs["none"][1]).abs().max())
    out["tokens_equal"] = bool(torch.equal(runs["mesh"][0], runs["none"][0]))
    out["cache_chunk_shape"] = shapes
    out["in_place"] = all(in_place)
    want_shape = [2, cfg.n_kv_heads, size["max_seq"] // WORLD, cfg.hd]
    out["ok"] = (max(errs.values()) < 1e-4 and out["logit_err"] < 1e-4
                 and out["tokens_equal"] and out["in_place"]
                 and shapes == want_shape)
    out["config"] = f"{cfg.name} width (heads {cfg.n_heads}/" \
        f"{cfg.n_kv_heads}, head_dim {cfg.hd}); attention over {s} cached " \
        f"rows, {chunk} a rank; model {cfg.n_layers} layers, " \
        f"{size['prompt']}-token prompt, {NEW_TOKENS} decode steps"
    return out


def check_moe(device: str, size: dict) -> dict:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist import context
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import layers as L
    mesh = mesh_mod.make_dev_mesh((WORLD,), ("data",), device=device)
    cfg = _config("phi3.5-moe-42b-a6.6b", device, attn_impl="torch")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CAPACITY))
    p = L.materialize(L.moe_meta(cfg), _generator(device, 5), device)
    rows, seq = size["moe_rows"]
    x = torch.randn((rows, seq, cfg.d_model), generator=_generator(device, 6),
                    device=device)
    want, want_aux = L.moe_block(cfg, p, x)
    dropped = L.moe_dropped(cfg, p, x)
    dm = mesh.device_mesh
    pd = L.tree_map(lambda t: distribute_tensor(t, dm, [Replicate()]), p)
    xd = distribute_tensor(x, dm, [Shard(0)])
    _sync(device)
    t0 = time.perf_counter()
    with context.use_mesh(mesh), implicit_replication():
        got, aux = L.moe_block(cfg, pd, xd)
        got, aux = got.full_tensor(), aux.full_tensor()
    _sync(device)
    out = {"dropped_pairs": dropped,
           "pairs": rows * seq * cfg.moe.top_k,
           "capacity": L.moe_capacity(cfg, rows * seq),
           "out_err": float((got - want).abs().max()),
           "aux_err": abs(float(aux) - float(want_aux)),
           "aux": float(want_aux), "seconds": time.perf_counter() - t0}
    out["ok"] = dropped > 0 and out["out_err"] < 1e-4 \
        and out["aux_err"] < 1e-6
    out["config"] = f"{cfg.name} width (d {cfg.d_model}, " \
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, expert d_ff " \
        f"{cfg.moe.d_ff_expert}), capacity factor {MOE_CAPACITY}, " \
        f"{rows} x {seq} tokens, {rows // WORLD} rows a rank"
    return out


def _slice(mesh, t, spec):
    """This rank's block of ``t`` under ``spec``."""
    from repro_torch.dist import sharding
    for d, entry in enumerate(spec):
        t = sharding.local_rows(mesh, t, entry, dim=d)
    return t


def check_reshard(device: str, size: dict) -> dict:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist import sharding
    from repro_torch.ft import trainer
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_leaves
    mesh = mesh_mod.make_dev_mesh((2, 2), ("data", "model"), device=device)
    cfg = _config("h2o-danube-1.8b", device, layers=size["layers"],
                  attn_impl="torch")
    params = M.init_params(cfg, _generator(device, 7), device)
    shardings = sharding.param_shardings(cfg, mesh)
    pairs = list(zip(tree_leaves(params), tree_leaves(shardings)))
    _sync(device)
    t0 = time.perf_counter()
    placed = trainer.reshard(params, shardings)
    _sync(device)
    t_reshard = time.perf_counter() - t0
    same = sum(torch.equal(pl.to_local(), _slice(mesh, w, ns.spec))
               for pl, (w, ns) in zip(tree_leaves(placed), pairs))
    where = [tempfile.mkdtemp(prefix="multicard_ckpt_")
             if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(where, src=0)
    try:
        if dist.get_rank() == 0:
            CheckpointManager(where[0]).save(0, params)
        dist.barrier()
        t0 = time.perf_counter()
        restored, _ = CheckpointManager(where[0]).restore(
            M.abstract_params(cfg), shardings=shardings)
        _sync(device)
        t_restore = time.perf_counter() - t0
        dist.barrier()
    finally:
        if dist.get_rank() == 0:
            shutil.rmtree(where[0], ignore_errors=True)
    same_restored = sum(
        r.to_local().device == w.device
        and torch.equal(r.to_local(), _slice(mesh, w, ns.spec))
        for r, (w, ns) in zip(tree_leaves(restored), pairs))
    split = sum(any(e is not None for e in ns.spec) for _, ns in pairs)
    out = {"leaves": len(pairs), "split_leaves": split,
           "reshard_equal": same, "restore_equal": same_restored,
           "seconds": {"reshard": t_reshard, "restore": t_restore}}
    out["ok"] = same == same_restored == len(pairs) and split > 0
    out["config"] = f"{cfg.name} ({cfg.n_layers} layers, d {cfg.d_model})"
    return out


def check_train_step(device: str, size: dict) -> dict:
    import math
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist import context, sharding
    from repro_torch.launch import census, shapes, steps
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    mesh = mesh_mod.make_dev_mesh((2, 2), ("data", "model"), device=device)
    cfg = _config("h2o-danube-1.8b", device, layers=size["layers"])
    cell = dataclasses.replace(shapes.make_cell("h2o-danube-1.8b",
                                                "train_4k"),
                               global_batch=size["grad_rows"],
                               seq_len=size["grad_seq"])
    seqs = torch.randint(0, cfg.vocab, (cell.global_batch, cell.seq_len + 1),
                         generator=_generator(device, 10), device=device)
    batch = {"tokens": seqs[:, :-1].to(torch.int32),
             "labels": seqs[:, 1:].to(torch.int32)}
    out: dict = {}
    with _float32():
        case = steps.make_case(cfg, cell, mesh, device=device,
                               fill=steps._zeros)
        # the step the case wraps, asked to keep its gradients
        step = steps.make_train_step(
            case.cfg, AdamWConfig(),
            accum_steps=steps.accum_for(case.cfg, cell), keep_grads=True)
        # the step owns (writes into) its parameters: each run its own
        params = M.init_params(case.cfg, _generator(device, 9), device)
        _sync(device)
        t0 = time.perf_counter()
        _, _, want = step(params, adamw_init(params), batch)
        _sync(device)
        out["seconds_no_mesh"] = time.perf_counter() - t0
        del params
        placed = tree_map(sharding.place, M.init_params(
            case.cfg, _generator(device, 9), device),
            sharding.param_shardings(case.cfg, mesh))
        placed_batch = {k: sharding.place(v, ns) for (k, v), ns in zip(
            batch.items(), steps._batch_shardings(mesh, batch).values())}
        _sync(device)
        t0 = time.perf_counter()
        with context.use_mesh(mesh), implicit_replication(), \
                census.Census() as c:
            _, _, got = step(placed, case.args[1], placed_batch)
        _sync(device)
        out["seconds_mesh"] = time.perf_counter() - t0
        loss = float(got["loss"].full_tensor())
        errs = leaf_errors(got["grads"], want["grads"])
    whole = cfg.vocab * cfg.d_model
    out.update(
        loss=loss, loss_rel=abs(loss - float(want["loss"]))
        / abs(float(want["loss"])), max_grad_err=max(e[1] for e in errs),
        leaves=len(errs), grad_errs=errs,
        embed_local_shape=list(placed["embed"].to_local().shape),
        whole_vocab_ops=[op for op in c.ops
                         if math.prod(op["shape"]) == whole],
        collective_bytes=c.collectives()["bytes_by_kind"])
    out["ok"] = (out["loss_rel"] < 1e-5
                 and all(err <= 1e-5 * scale + 1e-7 and err < 1e-4
                         for _, err, scale in errs)
                 and not out["whole_vocab_ops"]
                 and out["embed_local_shape"][0] == cfg.vocab // 2)
    out["config"] = f"{cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, " \
        f"vocab {cfg.vocab}), {cell.global_batch} x {cell.seq_len} " \
        f"tokens, float32 compute, (2, 2) data x model"
    return out


def _census_cell(arch: str, shape: str, device: str, size: dict):
    from repro_torch.launch import shapes
    cfg = _config(arch, device)
    cell = shapes.make_cell(arch, shape)
    cell = dataclasses.replace(
        cell, global_batch=size["census_batch"],
        seq_len=size["census_seq"] or cell.seq_len)
    return cfg, cell


def census_real(device: str, size: dict) -> dict:
    """The census of each ``CENSUS_CELLS`` step run for real on the live
    (2, 2) mesh: this rank's collective bytes by kind, FLOPs, temp and
    seconds."""
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as mesh_mod
    mesh = mesh_mod.make_dev_mesh((2, 2), ("data", "model"), device=device)
    out = {}
    for i, (arch, shape) in enumerate(CENSUS_CELLS):
        cfg, cell = _census_cell(arch, shape, device, size)
        case = steps.make_case(cfg, cell, mesh, device=device,
                               fill=steps.real_fill(_generator(device,
                                                               8 + i)))
        _sync(device)
        rec, secs = dryrun.run_case(case, mesh)
        _sync(device)
        out[f"{arch} {shape}"] = {
            "bytes_by_kind": rec["collectives"]["bytes_by_kind"],
            "flops": rec["flops"],
            "temp_bytes": rec["memory"]["temp_size_in_bytes"],
            "seconds": secs}
        del case
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def census_fake(device: str, size: dict) -> dict:
    """The same cells' census on a 4-rank fake mesh, as rank 0 (run in a
    fresh process: PyTorch keeps state of the real group's meshes that a
    fake mesh of the same shape would meet)."""
    from repro_torch.launch import dryrun
    out = {}
    for arch, shape in CENSUS_CELLS:
        cfg, cell = _census_cell(arch, shape, device, size)
        rec = dryrun.run_cell(arch, shape, False, cfg=cfg, cell=cell,
                              mesh_shape=((2, 2), ("data", "model")),
                              device=device)
        assert rec["status"] == "ok", rec.get("traceback")
        out[f"{arch} {shape}"] = {
            "bytes_by_kind": rec["collectives"]["bytes_by_kind"],
            "flops": rec["flops"], "seconds": rec["run_s"]}
    return out


CHECKS = (("dp_grads", check_dp_grads), ("ring_decode", check_ring_decode),
          ("moe", check_moe), ("reshard", check_reshard),
          ("train_step", check_train_step))


def _emit(line: dict, out_path) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    if out_path:
        with open(out_path, "a") as f:
            f.write(text + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=None,
                   help="also append rank 0's JSON lines to this file")
    args = p.parse_args(argv)
    device = args.device
    rank = int(os.environ["RANK"])
    if int(os.environ["WORLD_SIZE"]) != WORLD:
        raise SystemExit(f"run {WORLD} ranks, got "
                         f"{os.environ['WORLD_SIZE']}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    else:
        torch.set_num_threads(1)
    size = SIZES[device]
    t_start = time.perf_counter()
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(minutes=10))
    emit = functools.partial(_emit, out_path=args.out if rank == 0 else None)
    try:
        for name, check in CHECKS:
            t0 = time.perf_counter()
            res = check(device, size)
            res["wall_s"] = time.perf_counter() - t0
            every = [None] * WORLD
            dist.all_gather_object(every, res)
            if rank == 0:
                emit({"check": name, "ok": all(r["ok"] for r in every),
                      "rank0": every[0],
                      "failed_ranks": [i for i, r in enumerate(every)
                                       if not r["ok"]]})
            assert all(r["ok"] for r in every), (name, every)
            if device == "cuda":
                torch.cuda.empty_cache()
        t0 = time.perf_counter()
        real = census_real(device, size)
        every = [None] * WORLD
        dist.all_gather_object(every, real)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return 0
    kinds = [{k: r[k]["bytes_by_kind"] for k in r} for r in every]
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool:
        fake = pool.submit(census_fake, device, size).result()
    res = {"cells": {k: {"real": every[0][k], "fake": fake[k]}
                     for k in fake},
           "ranks_agree": all(x == kinds[0] for x in kinds),
           "wall_s": time.perf_counter() - t0}
    res["ok"] = res["ranks_agree"] and all(
        kinds[0][k] == fake[k]["bytes_by_kind"] for k in fake)
    emit({"check": "census", "ok": res["ok"], "rank0": res})
    assert res["ok"], res
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    emit({"ok": True, "world": WORLD, "backend": backend,
          "device": name, "checks": [n for n, _ in CHECKS] + ["census"],
          "seconds": time.perf_counter() - t_start})
    return 0


if __name__ == "__main__":
    sys.exit(main())
