"""The port's distribution layer on 8 gloo CPU ranks vs the reference.

One subprocess runs this file as a script: it starts 8 ranks
(``torch.multiprocessing``, one process each, a gloo process group over a
file store), each of which runs every check on its own tensors and
reports what it measured; rank 0 writes the reports to a JSON file.  The
tests below read that file, one test case per check, and hold each to
``tests/data/torch_port_dist_reference.json``, which
``tests/make_torch_port_dist_reference.py`` writes from the reference on
8 forced host devices (the reference's own multi-device proof runs there
too).  The inputs are numpy draws from that file's seeds, the same in
both packages.

Checks, with the reference's own bounds (``tests/test_dist.py``):
* ``hierarchical_psum`` within 1e-5 of the flat psum and of the
  reference's, on a (2, 4) ``("pod", "data")`` mesh; ``compressed_psum``
  within 1 % of the pod sum, its gathered int8 codes equal to the
  reference's; both with each rank's own input and with one input on
  every rank (the reference test's layout);
* ``make_dp_grad_fn`` on that mesh, the reference test's 2-layer model:
  ``flat`` and ``hier`` agree within 1e-6 per element and their losses
  within 1e-5 relative (bfloat16 compute, as shipped); in float32
  compute each schedule's gradient is within 1e-4 per leaf of the
  reference's (summation order only); ``hier`` + int8 is within its
  bound: the pods' int8 scales (one per reference leaf, a stage's
  repeats stacked) summed, halved and divided by the 8 ranks (each
  pod's rounding error is at most half its scale), plus 1e-6 for
  summation order (the reference's own bound between flat and hier);
* ``seq_sharded_attention`` on a (2, 4) ``("data", "model")`` mesh at
  (offset, window) = (40, None), (63, 16), (0, None), each rank handed
  its chunk of the cache (its batch row, 16 of the 64 rows): within 1e-5
  of ``attention_ref`` and of the reference's output;
* on a (2, 2, 2) mesh, the reference test's MoE model: every spec as long
  as its parameter, no axis used twice, equal to the reference's without
  the stacked leading entry; after ``ft.trainer.reshard`` and after
  ``CheckpointManager.restore(shardings=...)`` each rank's local shard
  equals the slice that the reference's ``devices_indices_map`` gives the
  device at the same mesh coordinate, bit for bit;
* a ``seq_shard`` smoke model's ``decode_step`` under the (2, 4) mesh,
  the no-mesh prefill's caches placed with ``sharding.shard_cache`` (each
  rank its chunk), equals the one without a mesh (float32 compute):
  logits within 1e-5, the same greedy tokens; and with its caches stored
  sharded by sequence
  (DTensors on ``cache_specs(seq_shard=True)``: each rank a 16-row chunk
  on a ring of 4, the new row written on its owning rank) it equals the
  whole-cache run within 1e-4 (its sums split over ranks), the same
  greedy tokens;
* mamba2-1.3b's and zamba2-1.2b's smoke models prefilled with DTensor
  parameters and prompt on the (2, 4) mesh (the Mamba blocks on each
  rank's shards: batch over ``data``, heads over ``model``) against the
  same prefill without DTensors, float32 compute: logits within 1e-4
  (sums split over ranks), the new SSM states within 1e-4;
* on the (2, 2, 2) mesh, a MoE block of DTensors (batch over ``pod`` x
  ``data``, experts over ``model``) with a capacity factor of 0.5, so
  that tokens drop, against the block without a mesh: outputs within
  1e-5, the auxiliary loss within 1e-6 (routing, capacity and the loss
  are the global batch's).

Run alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_dist_ranks.py`` (about 30 s, most of it the 8 ranks'
start-up).
"""
import base64
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "tests", "data",
                         "torch_port_dist_reference.json")
WORLD = 8
ATTN_CASES = ((40, None), (63, 16), (0, None))
LAYOUTS = ("distinct", "replicated")


def unpack(d) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]),
                         np.dtype(d["dtype"]).newbyteorder("<")).reshape(
        d["shape"]).astype(d["dtype"])


# ---------------------------------------------------------------------------
# the ranks (run by the subprocess)
# ---------------------------------------------------------------------------
def _paths(tree):
    """(reference path, repeat index or None, leaf) of a port tree: a
    stage's repeats, a list of unit dicts, share the reference's path."""
    from repro_torch.checkpoint.manager import _paths as walk
    for key, leaf, rep in walk(tree):
        yield key, None if rep is None else rep[0], leaf


def _plain_paths(tree, prefix=()):
    """(path, leaf) of a tree in the reference's layout (repeats stacked),
    the path its dict keys and list indices joined by "/"."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _plain_paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _plain_paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _hier(ref, mesh) -> dict:
    from repro_torch.dist import collectives, compression
    x_all = unpack(ref["x"])
    r = mesh.index(("pod", "data"))
    out = {}
    for layout in LAYOUTS:
        want = {k: unpack(v)[r] for k, v in ref[layout].items()}
        x = torch.from_numpy(x_all[r if layout == "distinct" else 0].copy())
        hier = collectives.hierarchical_psum(x, mesh=mesh).numpy()
        flat = collectives.psum(x, mesh.group(("pod", "data"))).numpy()
        pod = collectives.psum(x, mesh.group("pod")).numpy()
        comp = compression.compressed_psum(x, mesh.group("pod")).numpy()
        q, _ = compression.quantize(x)
        codes = collectives.all_gather(q[None], mesh.group("pod")).numpy()
        out[layout] = {
            "hier_vs_flat": float(np.abs(hier - flat).max()),
            "hier_vs_ref": float(np.abs(hier - want["hier"]).max()),
            "flat_vs_ref": float(np.abs(flat - want["flat"]).max()),
            "comp_rel": float(np.abs(comp - pod).max() / np.abs(pod).max()),
            "comp_vs_ref": float(np.abs(comp - want["comp"]).max()),
            "codes_equal": bool(np.array_equal(codes, want["codes"]))}
    return out


def _dense_cfg(ref, **kw):
    from repro_torch.models import ModelConfig
    return ModelConfig(**dict(ref["dense"], stages=((("attn",), 2),),
                              attn_impl="torch", **kw))


def _grads(ref_all, mesh) -> dict:
    import functools
    from repro_torch.dist import collectives, compression, data_parallel
    from repro_torch.dist import sharding
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_leaves, tree_map
    ref = ref_all["grads"]
    cfg = _dense_cfg(ref_all)
    seeds = ref_all["seeds"]
    params = convert.from_reference(
        cfg, convert.init_numpy(cfg, seeds["params"]), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(seeds["tokens"]).integers(
        0, cfg.vocab, (8, 16)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    lf = functools.partial(M.loss_fn, cfg)

    def run(**kw):
        return data_parallel.make_dp_grad_fn(lf, mesh, **kw)(params, batch)

    out = {}
    (l0, gf), (l1, gh) = run(schedule="flat"), run(schedule="hier")
    out["bf16"] = {"l0": float(l0), "l1": float(l1), "gerr": max(
        float((a - b).abs().max())
        for a, b in zip(tree_leaves(gf), tree_leaves(gh)))}
    compute = M.COMPUTE_DTYPE
    M.COMPUTE_DTYPE = torch.float32
    try:
        runs = {"flat": run(schedule="flat"), "hier": run(schedule="hier"),
                "int8": run(schedule="hier", compress=True)}
        # the int8 bound: each pod's inner-summed gradient is quantized
        # once, with error at most half its scale
        local = tree_map(lambda t: sharding.local_rows(mesh, t, (
            "pod", "data")), batch)
        _, g = data_parallel.value_and_grad(lf)(params, local)
        # one scale per reference leaf: a stage's repeats stacked
        scales = tree_map(lambda t: collectives.all_gather(
            compression.quantize(collectives.psum(
                t, mesh.group("data")))[1].reshape(1), mesh.group("pod")),
            collectives.stack_repeats(g))
    finally:
        M.COMPUTE_DTYPE = compute
    for name in ("flat", "hier"):
        loss, grads = runs[name]
        want = {"/".join(e["path"]): unpack(e) for e in ref[name]["grads"]}
        errs = {key: float(np.abs(leaf - want[key]).max()) for key, leaf
                in _plain_paths(convert.to_reference(cfg, grads))}
        assert len(errs) == len(want), (sorted(errs), sorted(want))
        out[name] = {"loss": float(loss), "ref_loss": ref[name]["loss"],
                     "max_leaf_err": max(errs.values())}
    loss8, g8 = runs["int8"]
    stack = collectives.stack_repeats
    excess = [float(((a - b).abs() - (s.sum() / 2 / WORLD + 1e-6)).max())
              for a, b, s in zip(tree_leaves(stack(g8)),
                                 tree_leaves(stack(runs["flat"][1])),
                                 tree_leaves(scales))]
    out["int8"] = {"loss": float(loss8), "flat_loss": float(runs["flat"][0]),
                   "max_excess": max(excess)}
    return out


def _attention(ref_all, mesh) -> dict:
    from repro_torch.dist import context, decode_attn, sharding
    from repro_torch.kernels import ref as kref
    rng = np.random.default_rng(ref_all["seeds"]["attention"])
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 6, 1, 32), (2, 3, 64, 32), (2, 3, 64, 32)))
    # this rank's chunk of the cache: its batch row, its 16 of the 64 rows
    rows = sharding.batch_entry(mesh, 2)
    i = mesh.coordinate()["model"]
    kc, vc = (sharding.local_rows(mesh, t, rows).narrow(2, i * 16, 16)
              for t in (k, v))
    out = {}
    for off, win in ATTN_CASES:
        with context.use_mesh(mesh):
            got = decode_attn.seq_sharded_attention(
                q, kc, vc, causal=True, window=win, q_offset=off, rows=rows)
        want = kref.attention_ref(q, k, v, causal=True, window=win,
                                  q_offset=off)
        out[f"{off}_{win}"] = {
            "vs_attention_ref": float((got - want).abs().max()),
            "vs_reference": float(np.abs(got.numpy() - unpack(
                ref_all["attention"][f"{off}_{win}"])).max())}
    return out


def _moe_cfg():
    from repro_torch.models import ModelConfig, MoEConfig
    return ModelConfig(name="t", family="moe", n_layers=2, d_model=32,
                       n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                       stages=((("moe",), 2),), head_dim=8, max_seq=32,
                       moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32),
                       attn_impl="torch")


def _local_checks(tree, full, ref_leaves, coord) -> list:
    """Leaves of a DTensor tree whose local shard differs from the
    reference device's slice of the full leaf."""
    bad = []
    fulls = {(k, r): leaf for k, r, leaf in _paths(full)}
    for key, r, leaf in _paths(tree):
        sl = ref_leaves[key]["slices"][coord]
        if r is not None:
            assert sl[0] == [0, ref_leaves[key]["shape"][0]], sl
            sl = sl[1:]
        want = fulls[(key, r)][tuple(slice(a, b) for a, b in sl)]
        local = leaf.to_local()
        if local.shape != want.shape or not torch.equal(local, want):
            bad.append((key, r))
    return bad


def _placements(ref_all, mesh, tmp: str) -> dict:
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist import sharding
    from repro_torch.ft import trainer
    from repro_torch.models import convert
    from repro_torch.models import model as M
    cfg = _moe_cfg()
    ref_leaves = {"/".join(e["path"]): e
                  for e in ref_all["placements"]["leaves"]}
    specs = dict(((k, r), s) for k, r, s in _paths_specs(
        sharding.param_specs(cfg, mesh)))
    abstract = M.abstract_params(cfg)
    bad_rank, bad_ref = [], []
    for key, r, leaf in _paths(abstract):
        spec = specs[(key, r)]
        flat = [a for e in spec for a in sharding.entry_axes(e)]
        if len(spec) != leaf.dim() or len(flat) != len(set(flat)):
            bad_rank.append(key)
        want = [tuple(e) if isinstance(e, list) else e
                for e in ref_leaves[key]["spec"]]
        if tuple(spec) != tuple(want[1:] if r is not None else want):
            bad_ref.append(key)
    params = convert.from_reference(cfg, convert.init_numpy(cfg, 0),
                                    device="cpu")
    shardings = sharding.param_shardings(cfg, mesh)
    coord = ",".join(str(mesh.coordinate()[a]) for a in mesh.axis_names)
    placed = trainer.reshard(params, shardings)
    if dist.get_rank() == 0:
        CheckpointManager(tmp).save(3, params)
    dist.barrier()
    restored, _ = CheckpointManager(tmp).restore(abstract,
                                                 shardings=shardings)
    return {"n": len(specs), "bad_rank": bad_rank, "bad_ref": bad_ref,
            "n_ref": len(ref_leaves),
            "reshard_bad": _local_checks(placed, params, ref_leaves, coord),
            "restore_bad": _local_checks(restored, params, ref_leaves,
                                         coord)}


def _paths_specs(tree, prefix=()):
    """(reference path, repeat index or None, spec) of a spec tree (whose
    ``P`` leaves are tuples, which ``_paths`` would walk into)."""
    from repro_torch.dist.sharding import P
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths_specs(v, prefix + (k,))
    elif isinstance(tree, list) and tree and isinstance(tree[0], dict):
        for r, unit in enumerate(tree):
            for key, _, s in _paths_specs(unit, prefix):
                yield key, r, s
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths_specs(v, prefix + (str(i),))
    else:
        assert isinstance(tree, P), tree
        yield "/".join(prefix), None, tree


def _decode(mesh) -> dict:
    from repro_torch import configs
    from repro_torch.dist import context, sharding
    from repro_torch.models import convert, smoke_config
    from repro_torch.models import model as M
    cfg = smoke_config(configs.get("h2o-danube-1.8b"), attn_impl="seq_shard")
    params = convert.from_reference(cfg, convert.init_numpy(cfg, 5),
                                    device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 40)))
    compute = M.COMPUTE_DTYPE
    M.COMPUTE_DTYPE = torch.float32
    try:
        logits, caches, _ = M.prefill(cfg, params, prompt, 64)
        runs = {}
        for name, mesh_or_none in (("mesh", mesh), ("none", None)):
            log, pos, toks, steps = logits, prompt.shape[1], [], []
            # the mesh run holds each rank's chunk of the cache only
            c = sharding.shard_cache(caches, mesh) if mesh_or_none \
                else caches
            for _ in range(3):
                nxt = torch.argmax(log[:, -1], -1)[:, None]
                toks.append(nxt)
                with context.use_mesh(mesh_or_none):
                    log, c = M.decode_step(cfg, params, c, nxt, pos)
                steps.append(log)
                pos += 1
            runs[name] = (torch.cat(toks, 1), torch.stack(steps))
    finally:
        M.COMPUTE_DTYPE = compute
    return {"window": cfg.sliding_window,
            "logit_err": float((runs["mesh"][1] - runs["none"][1]).abs()
                               .max()),
            "tokens_equal": bool(torch.equal(runs["mesh"][0],
                                             runs["none"][0]))}


def _decode_sharded(mesh) -> dict:
    """``_decode``'s model served with its caches stored sharded by
    sequence over ``model`` (a ring of 4): parameters and prompt as
    DTensors, so prefill places the caches on ``cache_specs(seq_shard=
    True)`` and each decode step writes the new row on its owning rank
    and runs the ring on the local chunks; held to the whole-cache run
    under the same mesh."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.dist import context
    from repro_torch.models import convert, smoke_config
    from repro_torch.models import model as M
    cfg = smoke_config(configs.get("h2o-danube-1.8b"), attn_impl="seq_shard",
                       act_shard="none")
    params = convert.from_reference(cfg, convert.init_numpy(cfg, 5),
                                    device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 40)))
    dm = mesh.device_mesh
    compute = M.COMPUTE_DTYPE
    M.COMPUTE_DTYPE = torch.float32
    runs, chunks = {}, []
    try:
        for name in ("whole", "sharded"):
            if name == "sharded":
                p = M.L.tree_map(lambda t: distribute_tensor(
                    t, dm, [Replicate(), Replicate()]), params)
                tok = distribute_tensor(prompt, dm, [Shard(0), Replicate()])
            else:
                p, tok = params, prompt
            with context.use_mesh(mesh), implicit_replication():
                log, c, _ = M.prefill(cfg, p, tok, 64)
                pos, toks, steps = prompt.shape[1], [], []
                for _ in range(3):
                    nxt = torch.argmax(log[:, -1], -1)[:, None]
                    toks.append(nxt)
                    log, c = M.decode_step(cfg, p, c, nxt, pos)
                    steps.append(log)
                    pos += 1
                if name == "sharded":
                    k = c[0][0]["0"]["self"]["k"]
                    chunks = [list(k.shape), list(k.to_local().shape)]
                    toks = [t.full_tensor() for t in toks]
                    steps = [t.full_tensor() for t in steps]
            runs[name] = (torch.cat(toks, 1), torch.stack(steps))
    finally:
        M.COMPUTE_DTYPE = compute
    return {"logit_err": float((runs["sharded"][1] - runs["whole"][1])
                               .abs().max()),
            "logit_scale": float(runs["whole"][1].abs().max()),
            "tokens_equal": bool(torch.equal(runs["sharded"][0],
                                             runs["whole"][0])),
            "cache_shapes": chunks}


def _mamba_sharded(mesh) -> dict:
    """The Mamba blocks on each rank's shards (``layers._mamba_sharded``)
    against the plain blocks: one prefill each of mamba2-1.3b's and
    zamba2-1.2b's smoke models, with and without DTensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.dist import context
    from repro_torch.models import convert, smoke_config
    from repro_torch.models import model as M
    compute = M.COMPUTE_DTYPE
    M.COMPUTE_DTYPE = torch.float32
    out = {}
    try:
        for arch in ("mamba2-1.3b", "zamba2-1.2b"):
            cfg = smoke_config(configs.get(arch), attn_impl="torch",
                               act_shard="none")
            params = convert.from_reference(cfg, convert.init_numpy(cfg, 7),
                                            device="cpu")
            prompt = torch.from_numpy(np.random.default_rng(8).integers(
                0, cfg.vocab, (2, 24)))
            log, c, _ = M.prefill(cfg, params, prompt, 32)
            dm = mesh.device_mesh
            p = M.L.tree_map(lambda t: distribute_tensor(
                t, dm, [Replicate(), Replicate()]), params)
            tok = distribute_tensor(prompt, dm, [Shard(0), Replicate()])
            with context.use_mesh(mesh), implicit_replication():
                dlog, dc, _ = M.prefill(cfg, p, tok, 32)
                dlog = dlog.full_tensor()
                i = next(k for k in c[0][0] if "mamba" in c[0][0][k])
                state = dc[0][0][i]["mamba"]["ssm"].full_tensor()
            out[arch] = {
                "logit_err": float((dlog - log).abs().max()),
                "logit_scale": float(log.abs().max()),
                "state_err": float((state - c[0][0][i]["mamba"]["ssm"])
                                   .abs().max())}
    finally:
        M.COMPUTE_DTYPE = compute
    return out


def _moe(mesh) -> dict:
    """A MoE block on each rank's shards (batch over ``pod`` x ``data``,
    experts over ``model``) against the block without a mesh, where
    capacity binds."""
    import dataclasses
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist import context
    from repro_torch.models import layers as L
    cfg = _moe_cfg()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    p = L.materialize(L.moe_meta(cfg), torch.Generator().manual_seed(9),
                      "cpu")
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (8, 16, cfg.d_model)).astype(np.float32))
    want, want_aux = L.moe_block(cfg, p, x)
    dm = mesh.device_mesh
    pd = L.tree_map(lambda t: distribute_tensor(t, dm, [Replicate()] * 3),
                    p)
    xd = distribute_tensor(x, dm, [Shard(0), Shard(0), Replicate()])
    with context.use_mesh(mesh), implicit_replication():
        got, aux = L.moe_block(cfg, pd, xd)
        got, aux = got.full_tensor(), aux.full_tensor()
    return {"dropped": L.moe_dropped(cfg, p, x),
            "out_err": float((got - want).abs().max()),
            "aux_err": abs(float(aux) - float(want_aux))}


def _rank(rank: int, init: str, tmp: str, out_path: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    with open(REFERENCE) as f:
        ref = json.load(f)
    pd = mesh_mod.make_dev_mesh((2, 4), ("pod", "data"), device="cpu")
    dm = mesh_mod.make_dev_mesh((2, 4), ("data", "model"), device="cpu")
    pdm = mesh_mod.make_dev_mesh((2, 2, 2), ("pod", "data", "model"),
                                 device="cpu")
    report = {
        "rank": rank,
        "coordinates": [pd.coordinate(), dm.coordinate(), pdm.coordinate()],
        "group_sizes": {",".join(a): dist.get_world_size(pdm.group(a))
                        for a in (("pod",), ("data",), ("model",),
                                  ("pod", "data"), ("data", "model"),
                                  ("pod", "data", "model"))},
        "hier": _hier(ref["hier"], pd),
        "grads": _grads(ref, pd),
        "attention": _attention(ref, dm),
        "placements": _placements(ref, pdm, os.path.join(tmp, "ckpt")),
        "decode": _decode(dm),
        "decode_sharded": _decode_sharded(dm),
        "mamba_sharded": _mamba_sharded(dm),
        "moe": _moe(pdm)}
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
        mp.spawn(_rank, args=(f"file://{tmp}/store", tmp, out_path),
                 nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1])


# ---------------------------------------------------------------------------
# the tests (one subprocess start for the whole file)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks") / "reports.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out) as f:
        reps = json.load(f)
    assert [r["rank"] for r in reps] == list(range(WORLD))
    return reps


def test_ranks_sit_row_major_and_groups_span_their_axes(reports):
    for r in reports:
        rank = r["rank"]
        assert r["coordinates"][0] == {"pod": rank // 4, "data": rank % 4}
        assert r["coordinates"][1] == {"data": rank // 4, "model": rank % 4}
        assert r["coordinates"][2] == {"pod": rank // 4,
                                       "data": rank // 2 % 2,
                                       "model": rank % 2}
        assert r["group_sizes"] == {"pod": 2, "data": 2, "model": 2,
                                    "pod,data": 4, "data,model": 4,
                                    "pod,data,model": 8}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_hierarchical_psum_matches_flat_and_reference(reports, layout):
    for r in reports:
        h = r["hier"][layout]
        assert h["hier_vs_flat"] < 1e-5, h
        assert h["hier_vs_ref"] < 1e-5, h
        assert h["flat_vs_ref"] < 1e-5, h


@pytest.mark.parametrize("layout", LAYOUTS)
def test_compressed_psum_within_one_percent_with_reference_codes(reports,
                                                                 layout):
    for r in reports:
        h = r["hier"][layout]
        assert h["comp_rel"] < 0.01, h
        assert h["codes_equal"], h
        assert h["comp_vs_ref"] < 1e-5, h


def test_dp_grad_schedules_agree(reports):
    for r in reports:
        g = r["grads"]["bf16"]
        assert g["l0"] == pytest.approx(g["l1"], rel=1e-5)
        assert g["gerr"] < 1e-6, g
    assert len({r["grads"]["bf16"]["l0"] for r in reports}) == 1


@pytest.mark.parametrize("schedule", ["flat", "hier"])
def test_dp_grads_match_reference(reports, schedule):
    for r in reports:
        g = r["grads"][schedule]
        assert g["loss"] == pytest.approx(g["ref_loss"], rel=1e-5)
        assert g["max_leaf_err"] < 1e-4, g


def test_dp_int8_schedule_within_its_bound(reports):
    for r in reports:
        g = r["grads"]["int8"]
        assert g["loss"] == pytest.approx(g["flat_loss"], rel=1e-5)
        assert g["max_excess"] <= 0.0, g


@pytest.mark.parametrize("case", [f"{o}_{w}" for o, w in ATTN_CASES])
def test_seq_sharded_attention_matches_ref_and_reference(reports, case):
    for r in reports:
        a = r["attention"][case]
        assert a["vs_attention_ref"] < 1e-5, a
        assert a["vs_reference"] < 1e-5, a


def test_placements_valid_and_equal_reference(reports):
    for r in reports:
        p = r["placements"]
        assert p["bad_rank"] == [] and p["bad_ref"] == []
        assert p["n"] > 10
    # every reference leaf has its port leaves (a stage's repeats apart)
    assert reports[0]["placements"]["n_ref"] == 13


def test_reshard_local_shards_equal_reference_slices(reports):
    for r in reports:
        assert r["placements"]["reshard_bad"] == []


def test_restore_with_shardings_local_shards_equal_reference_slices(reports):
    for r in reports:
        assert r["placements"]["restore_bad"] == []


def test_seq_shard_decode_under_mesh_equals_no_mesh(reports):
    for r in reports:
        d = r["decode"]
        assert d["window"] == 32
        assert d["logit_err"] < 1e-5, d
        assert d["tokens_equal"], d


def test_seq_shard_decode_with_sharded_cache_equals_whole_cache(reports):
    """The cache stored sharded by sequence on a ring of 4 (each rank 16
    of its 64 rows, batch split over ``data``) decodes as the whole cache
    does.  Limit 1e-4 on logits of about 0.6: the sharded run also splits
    the MLP and the norms over ``model`` (DTensor), so its float32 sums
    run in another order, and a difference of one float32 ulp can flip
    the bfloat16 rounding of a cache entry (2**-8 of it); the whole-cache
    run against no mesh computes the same sums in the same order (1e-5
    above)."""
    for r in reports:
        d = r["decode_sharded"]
        assert d["cache_shapes"] == [[2, 2, 64, 16], [1, 2, 16, 16]], d
        assert d["logit_err"] < 1e-4, d
        assert d["tokens_equal"], d


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_mamba_blocks_on_shards_equal_plain_blocks(reports, arch):
    """The Mamba blocks on each rank's shards (input projections and
    mixer in one local region, heads over ``model``) prefill as the plain
    blocks do.  Limit 1e-4: the shards' float32 sums (the norms, the
    output projection's pending sum) run in another order."""
    for r in reports:
        d = r["mamba_sharded"][arch]
        assert d["logit_err"] < 1e-4, d
        assert d["state_err"] < 1e-4, d


def test_moe_on_shards_routes_the_global_batch(reports):
    """Capacity binds (pairs were dropped), and the block on each rank's
    rows routes, fills capacity and takes the auxiliary loss as the
    block on the whole batch does: the capacity from the global token
    count, each pair's slot its place in the global token order, the
    loss from the global means.  Limit 1e-5 on outputs of about 3:
    float32 sums over other row blocks; 1e-6 on the loss."""
    for r in reports:
        d = r["moe"]
        assert d["dropped"] > 0, d
        assert d["out_err"] < 1e-5, d
        assert d["aux_err"] < 1e-6, d
