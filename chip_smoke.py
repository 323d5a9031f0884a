"""Drive the PyTorch/CUDA port (the NoC simulator, its fabric analysis,
the model zoo with its cross-attention models, the training path and the
distribution layer) on one NVIDIA card.

    python3 chip_smoke.py

Runs from a checkout of the repository, needs one CUDA device and nvcc,
and imports nothing of jax or of the JAX reference package.  It builds the
port's four CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
each, started together) and runs twenty phases; any failure raises and
exits non-zero.

1. Device: the card's name and power limit (``nvidia-smi``), the kernels'
   build time and their register reports, and the measured cost of one
   of noc_step's barriers at each cluster size 1-8.
2. Kernel vs plain twin on the card, bit for bit: ``SimResult`` and
   ``kind_diagnostics`` over the 16-PE matrix of both families, 64 PEs
   under the paper's locality, a morph overlay, a repaired fabric, one
   1024-PE point, a batched sweep against per-point runs, and every
   kernel mode at 64 PEs split over clusters of 2, 3 and 8 CTAs.
3. The main path at full width: the figs15_17 recipe (src_queue_depth 8,
   the paper's locality, uniform / bit_reversal / transpose at injection
   rate 0.625, 900 cycles with 300 of warm-up, seed 1) at 256 and 1024
   PEs for both families through ``run_experiments`` on the CUDA backend,
   held field for field to ``tests/data/torch_port_reference.json`` (the
   JAX reference's results).  Launch counts are zeroed just before and
   read just after.
4. Times, with CUDA events after a warm-up: kernel ms per launch and us
   per cycle per point on the main path's shapes, each launch's cluster
   size C, shared bytes per CTA (checked against the kernel's own count)
   and barrier cost (and, at C > 1, how many such clusters the card holds
   at once and the share of route hops that cross CTAs), the twin's time
   on the card, and the least time the card could take for the same work;
   each launch's output equals the twin's.  Then each launch held to one
   arbitration pass a cycle, and split over 8 CTAs.  Then the streams
   kernel against its plain version on the card, bit for bit in all three
   outputs, on the paper's grid (12 points at 1024 PEs x 1500 cycles) and
   on the same points with 8 fault entries each: its launch and the plain
   version timed, beside the least time its hashes' instructions take.
5. Trace replay at full width: the recipe of ``benchmarks/trace_replay.py``
   (the three mined collective schedules, 64/256/1024 PEs, both families,
   ``src_queue_depth=8``, injection rate 1.0, seed 1) through
   ``Experiment.run_grid`` on the CUDA backend, held field for field to
   ``tests/data/torch_port_trace_fault_reference.json`` and, for
   ``completion_cycles`` and ``delivered``, to the 18 ``trace_replay`` rows
   of ``BENCH_noc.json``; kernel == twin on the card at 64 and 256 PEs; the
   stall-watchdog demo (16 PEs, strict and lenient barriers).  Then the
   record walk at the MoE cell's size (``phase_records``): two DeepSeek-V3
   layers' dispatch and combine on the 1024-PE ring-mesh with the cell's
   tokens a PE, flit scale and budget, one ``run_fused`` launch in records
   form each (the trace-mode launch count read after a drain) against
   ``run_plain`` on the same card tensors, every output equal, both phases
   settled, every flit delivered; then timed.
6. Runtime faults: the recipe of ``benchmarks/fault_sweep.py`` at 256 and
   1024 PEs (healthy, 2/4/8 dead links x fault seeds 0/1 unrepaired, the
   repaired twin) through ``run_experiments``, held to the same reference
   file with conservation checked per point; kernel == twin on the card at
   64 PEs, a transient fault with a late onset included.
7. Times of the trace and fault modes, as in phase 4, on every launch of
   phases 5 and 6 that runs them, and the record walk's.
8. ``flash_attention`` and ``ssd_scan`` against their plain versions on
   the card: the CPU tests' matrices in float32 and bfloat16, then the
   full-width shapes in bfloat16 (Zamba2 scoring, h2o-danube's window and
   offset, width 128, qwen2-7b scoring and h2o-danube scoring; the SSD at
   Zamba2 scoring and at mamba2-1.3b's d_state 128, 8 heads and its
   scoring shape), each timed with CUDA events beside its plain version,
   ``scaled_dot_product_attention`` for attention (a yardstick the port
   never calls) and the time of the scalar-FMA kernel the tensor-core one
   replaced, and its bound and share of it.  The SSD runs and is timed
   at every split of P over k blocks that fits, each split's shared
   bytes (the kernel's own count) checked against ``ssd_scan.plan``; at
   d_state 128 it also runs in float32, the scalar kernel split over
   ``plan``'s k blocks, held to its plain version within 3e-4.  Then the
   cross-attention models' ragged lengths (none tiles by 128): whisper's
   encoder, cross- and decoder self-attention, the vision model's
   cross-attention and one cross decode row, each in bfloat16 (timed
   beside SDPA and its bound) and in float32.
9. The scoring path at full width: ``zamba2-1.2b`` (38 layers, d_model
   2048) from ``init_params`` on the card scores 2 x 4096 tokens through
   ``forward`` -> ``unembed`` and ``loss_fn``; 38 ``ssd_scan`` and 6
   ``flash_attention`` launches per forward; logits and loss held against
   the plain route (``attn_impl="torch"``) on the card; host and device
   time per forward.
10. The JAX anchor: the same model at full width with its depth cut to one
   6-layer unit, on the numpy weights of
   ``tests/data/torch_port_model_reference.json``'s seed, held to that
   file's loss and top-10 logits (the JAX package's, ``attn_impl="xla"``).
11. Serving at full width: ``ServeEngine`` on phase 9's model, 4 slots,
   ``max_seq`` 512, 6 requests with 64-256-token prompts and 16-32 new
   tokens; every request completes, no kernel launches (prefill and
   decode take the plain routes, as in the reference); tokens per second.
12. The fabric analysis on the card: every certificate of
   ``tests/data/torch_port_fabric_reference.json`` (the config grid to
   1024 PEs, two morph overlays, the repaired fabrics, the fault recipe's
   repaired fabrics at 64-1024 PEs and the BFS-refill cycle) certified
   with ``device="cuda"`` and held to the JAX reference's as JSON; the
   certification time at 1024 PEs on the card and on its host; phase 3's
   grid again behind ``Experiment(verify=True)``, held to the same
   reference, with the certification's share of the wall clock and a
   second construction served from the certificate cache;
   ``measure_repair`` on the fault recipe's repair scenario at 256 and
   1024 PEs, its legs held to phase 6's reports and its ``certified``
   block to the reference certificate; the BFS-refill cycle's witness.
13. The decoder-only zoo scored at full width (phase 11's model freed
   first): qwen2-7b (28 layers, 2 x 4096 tokens), h2o-danube-1.8b (24
   layers, 1 x 8192, the window binds), mamba2-1.3b (48 layers, 2 x
   4096), and at their published widths with the depth cut for device
   memory qwen2.5-14b (12 of 48 layers), phi3.5-moe (4 of 32),
   llama4-scout (2 of 48, 2 x 2048) and command-r-plus (2 of 64, 1 x
   4096), each from ``init_params`` on the card: one launch per layer
   per forward, logits and loss held to the plain route (on MoE models
   at the tokens both runs routed alike, experts and capacity), device
   ms and tokens/s per forward split into the kernels and the rest, and
   a float32-compute check on all but qwen2.5-14b and command-r-plus.
14. The JAX anchor for the zoo: one full-width layer of qwen2-7b,
   h2o-danube-1.8b, mamba2-1.3b and phi3.5-moe on the numpy weights of
   ``tests/data/torch_port_zoo_reference.json``'s seed (fingerprints
   checked), held to that file's top-10 logits, loss, auxiliary loss
   and phi3.5-moe's routing.
15. Serving qwen2-7b (28 layers) and phi3.5-moe (4 layers), redrawn as
   in phase 13, with phase 11's recipe: every request completes, no
   kernel launches, prefill against a cache-free plain forward.
16. The cross-attention models scored at full width, every layer:
   whisper-small (12 encoder + 12 decoder layers, weights from
   ``convert.init_numpy``; 16 x 448 tokens over 16 x 1 500 frames; 36
   flash launches per forward) and llama-3.2-vision-11b (40 layers, 40.4
   GB of float32 parameters from ``init_params`` on the card; 2 x 4 096
   tokens over 2 x 1 600 image tokens; 48 launches), frames and image
   embeddings seeded normals; held to the plain route as in phase 13
   (whisper also with float32 compute); device ms, tokens/s and the
   kernels' share per forward.
17. The JAX anchor for them: whisper-small with one encoder and one
   decoder layer and one vision unit (4 ``attn`` + 1 ``cross``) at full
   width on the numpy weights and memory of
   ``tests/data/torch_port_cross_reference.json``'s seed, held to its
   top-10 logits and loss, and whisper's gradient (the plain route) to
   its global and per-leaf norms.
18. Prefill + decode of both models (phase 16's weights): 2 requests, 16
   new tokens each, through ``prefill(frames= / img_embeds=)`` and
   ``decode_step``; the cross layers launch the kernel at prefill and at
   every decode step; the first decode step held to the plain route.
19. Training at full width: mamba2-1.3b (6 of its 48 layers, remat, the
   plain route; phase 21(b) trains it at full depth) through ``FaultTolerantTrainer`` + ``CheckpointManager`` +
   AdamW, 4 x 2 048 tokens from ``TokenPipeline`` for 6 steps, a
   checkpoint every 2 and one injected failure at step 3: it resumes at
   step 2 with the pipeline's cursor restored, the restored state equals
   the saved one bit for bit, losses and grad norms stay finite and the
   loss falls; then two ``make_train_step`` steps of whisper-small with
   frames in the batch.  Seconds per step, tokens/s, peak memory.
20. The distribution layer (a process group is global state: the phase
   destroys it at its end): a one-rank NCCL process group
   (``tcp://localhost``, any free port) and a (1, 1, 1) ``("pod", "data",
   "model")`` mesh on the card; ``make_dp_grad_fn`` on h2o-danube-1.8b at
   full width, 12 of its 24 layers (the plain route with remat, 8 x 512
   tokens; ``launch/multicard.py`` takes them at full depth on four cards)
   under ``flat``,
   ``hier`` and ``hier`` + int8, held to the no-mesh value and gradient
   (``flat`` and ``hier`` bit for bit, int8 within half a step per
   element), each timed (seconds per gradient, tokens/s, peak memory);
   the same model served with ``attn_impl="seq_shard"`` (2 requests, 16
   new tokens), its first decode step held to the plain route;
   ``reshard`` and a ``CheckpointManager`` save + ``restore(shardings=
   ...)`` of its parameters onto the mesh's placements, every local shard
   equal to the saved leaf bit for bit.  No kernel launches.
21. The dry run on the card's terms (``repro_torch.launch``; each cell
   brings up and ends its own ``"fake"`` process group, so it runs after
   phase 20).  (a) Fake dry runs at full size on fake CUDA tensors
   (``dryrun.run_cell``, no memory allocated): qwen2-7b ``decode_32k``
   and h2o-danube-1.8b ``long_500k`` on the single-pod (16, 16) mesh,
   mamba2-1.3b ``prefill_32k`` on the multi-pod (2, 16, 16) mesh (on
   the kernel route; a prefill takes the plain routes, as the
   reference's does, so the ``ssd_scan`` custom op is not reached
   there): memory, FLOPs, collectives by kind, the data-sheet roofline
   terms (predictions) and the fake run's seconds.  (b) One-card
   real runs: h2o-danube-1.8b ``prefill_32k`` at batch 1 of 32, qwen2-7b
   ``decode_32k`` at batch 8 of 128, h2o-danube-1.8b ``long_500k`` at
   its own batch of 1, whisper-small ``decode_32k`` at batch 8 of 128
   and mamba2-1.3b ``train_4k`` (remat, AdamW in place) at batch
   ``TRAIN_CELL_BATCH`` of 256, every layer at full width, each once as
   a fake run
   on a one-rank fake mesh and once for real on the card (the same
   case's step on real tensors of the same local shapes,
   ``attn_override="cuda"``): the fake FLOPs equal the real run's census
   exactly, the argument bytes equal the real arguments' exactly, the
   predicted temp lies within ``TEMP_BAND`` of
   ``torch.cuda.max_memory_allocated()`` above the arguments, and the
   step's measured time stands beside its roofline bound; flash launches
   per step counted and printed.  The decode and training steps own
   their arguments, as the reference's donated ones: the caches (and
   the parameters and moments) they return are the argument tensors
   themselves, asserted by their storage.  Self-attention against a
   cache takes
   the plain route, as in the reference, so the first three cells launch
   no kernel; whisper-small's decode step reaches ``flash_attention``
   through its cross-attention (one launch a layer, asserted), so the
   custom op's fake implementation and FLOP formula meet the real launch
   there.

Launch counts are zeroed just before each of phases 3, 5, 6, 9, 11,
12's ``verify=True`` grid and ``measure_repair`` runs, each model's run
in phases 13-18, phase 19's training and phase 20's gradients and
serving, and read just after (by mode
for noc_step; phase 3 also counts the streams kernel's launches).  Phases
5 and 6 split their host wall clock into its stages (topology builds,
device geometry, streams and operands, the kernel, the reachability
walk, the rest), phase 9 its forward's into the two kernels and the
rest, each with its share, and phases 13 and 16 each model's.  The
kernels' record counts the launches of phases 9, 13, 14, 16, 17 and 18
for the model zoo's two kernels.  The line before the last is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(ROOT, "tests", "data", "torch_port_reference.json")
TRACE_FAULT_REFERENCE = os.path.join(
    ROOT, "tests", "data", "torch_port_trace_fault_reference.json")
BENCH = os.path.join(ROOT, "BENCH_noc.json")
MODEL_REFERENCE = os.path.join(ROOT, "tests", "data",
                               "torch_port_model_reference.json")
SOURCES = {
    "noc_step": "src/repro_torch/kernels/csrc/noc_step.cu",
    "noc_step[trace]": "src/repro_torch/kernels/csrc/noc_step.cu",
    "noc_step[faults]": "src/repro_torch/kernels/csrc/noc_step.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "streams": "src/repro_torch/kernels/csrc/streams.cu",
}
REPLACES = {
    "noc_step": "src/repro/kernels/noc_step.py:371",
    "noc_step[trace]":
        "src/repro/kernels/noc_step.py:137-148,294-304,329-365,538-552",
    "noc_step[faults]": "src/repro/kernels/noc_step.py:232-241,506-525",
    "flash_attention": "src/repro/kernels/flash_attention.py:29",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:32",
    # no Pallas kernel: the reference draws its streams with jax.random
    "streams": "src/repro/core/sim.py:532-553",
}

# Published H100 SXM peaks (NVIDIA data sheet) used for the bound: device
# memory at 3.35 TB/s, and 67 T/s for scalar work outside the tensor
# cores (the data sheet's float32 rate; the kernel's work is int32 ALU).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# The dense bf16 tensor-core peak: the bound of the model zoo's kernels,
# whose inputs on the main path are bfloat16.
BF16_OPS_PER_S = 989e12
# Instruction throughput, the bound of the streams kernel's integer hashing:
# 132 SMs, each with 4 schedulers that dispatch one 32-thread instruction a
# clock, at the 1.98 GHz boost clock.  A Threefry-2x32 hash takes at least
# 60 (20 rounds of an add, a funnel shift and a xor).
INSTRUCTIONS_PER_S = 132 * 4 * 32 * 1.98e9
HASH_INSTRUCTIONS = 60

CARD = ""  # "name, power limit" as nvidia-smi reports them


def say(phase: int, msg: str) -> None:
    print(f"[phase {phase}] {msg}", flush=True)


def fields(r) -> dict:
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
            if f.name != "cfg"}


def result_err(a, b) -> float:
    """Largest absolute difference over two results' numeric fields,
    per-phase completion cycles included."""
    fa, fb = fields(a), fields(b)
    err = max(abs(fa[k] - fb[k]) for k in fa
              if isinstance(fa[k], (int, float)))
    if len(fa["phase_done"]) != len(fb["phase_done"]):
        return float("inf")
    return max([err] + [abs(x - y) for x, y in zip(fa["phase_done"],
                                                   fb["phase_done"])])


def as_reference(r) -> dict:
    """A SimResult's fields as the reference JSON records them."""
    d = fields(r)
    d["phase_done"] = list(d["phase_done"])
    return d


@contextlib.contextmanager
def host_clock(targets):
    """Host seconds spent inside each of ``targets`` ((owner, attribute)
    pairs) while the block runs: each is wrapped for the block's length,
    and the device is synchronized before a call's clock stops, so a call
    that launches device work is charged for it."""
    spent, saved = {}, []
    for owner, name in targets:
        fn = getattr(owner, name)
        spent[name] = 0.0

        def wrapped(*a, _fn=fn, _name=name, **k):
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                spent[_name] += time.perf_counter() - t
        saved.append((owner, name, fn))
        setattr(owner, name, wrapped)
    try:
        yield spent
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def host_split(wall: float, spent: dict) -> str:
    parts = [f"{k} {v:.3f} s" for k, v in spent.items()]
    return (f"{wall:.3f} s host wall clock = " + ", ".join(parts)
            + f", rest {wall - sum(spent.values()):.3f} s")


def clocked_targets():
    """The host-side stages of a run that ``host_clock`` times apart:
    topology builds, device geometry, random streams and operands, the
    kernel (run_fused, synchronized) and the reachability walk."""
    from repro_torch.core import sim
    from repro_torch.core.spec import TopologySpec
    from repro_torch.kernels import noc_step
    return ((TopologySpec, "build"), (sim, "build_geometry"),
            (sim, "batch_operands"), (noc_step, "run_fused"),
            (sim, "_fault_reachability"))


# ---------------------------------------------------------------------------
def phase_device():
    global CARD
    from repro_torch.kernels import flash_attention, noc_step, ssd_scan, \
        streams
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    say(1, f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"device {torch.cuda.get_device_name(0)} "
           f"count {torch.cuda.device_count()}")
    # One nvcc per source, all started together.
    t0 = time.perf_counter()
    mods = (noc_step, flash_attention, ssd_scan, streams)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        futures = [pool.submit(m.load_library) for m in mods]
        for f in futures:
            f.result()
    say(1, f"noc_step, flash_attention, ssd_scan and streams kernels built "
           f"and loaded in {time.perf_counter() - t0:.3f} s")
    for m in mods:
        for line in m.LIBRARY.log.splitlines():
            if "registers" in line or "spill" in line:
                say(1, f"ptxas [{m.LIBRARY.name}]: " + line.strip())
    for c in range(1, noc_step.MAX_CLUSTER + 1):
        cost = barrier_cost(c)
        fewer = [noc_step.barrier_cost(c, t)["ns"] for t in (256, 512)]
        say(1, f"noc_step {'block' if c == 1 else 'cluster'} barrier at "
               f"cluster size {c}: {cost['ns']:.1f} ns ({cost['cycles']:.0f} "
               f"SM cycles) with 1 024 threads per CTA; {fewer[0]:.1f} / "
               f"{fewer[1]:.1f} ns with 256 / 512 [{CARD}]")

_BARRIER: dict = {}


def barrier_cost(cluster: int) -> dict:
    """The measured cost of one of noc_step's barriers at a cluster size
    (measured once per size and run)."""
    from repro_torch.kernels import noc_step
    if cluster not in _BARRIER:
        _BARRIER[cluster] = noc_step.barrier_cost(cluster)
    return _BARRIER[cluster]


def phase_parity():
    """Kernel vs twin on the card.  Returns the largest difference seen."""
    from repro_torch.core import sim, sweep, topology
    from repro_torch.core.spec import MorphOverlay, TopologySpec
    from repro_torch.faults import sample_faults

    err = 0.0

    def both(topo, label, diag=True, **kw):
        nonlocal err
        a = sim.simulate(topo, sim.SimConfig(backend="cuda", **kw))
        b = sim.simulate(topo, sim.SimConfig(backend="torch", **kw))
        err = max(err, result_err(a, b))
        assert fields(a) == fields(b), (label, fields(a), fields(b))
        assert a.lost == 0, label
        if diag:
            da = sim.kind_diagnostics(topo, sim.SimConfig(backend="cuda",
                                                          **kw))
            db = sim.kind_diagnostics(topo, sim.SimConfig(backend="torch",
                                                          **kw))
            assert da == db, (label, da, db)
        say(2, f"{label}: kernel == twin (delivered {a.delivered}, "
               f"dropped {a.dropped}, in_flight {a.in_flight})")
        return a

    base = dict(cycles=300, warmup=100)
    for fam in ("ring_mesh", "flat_mesh"):
        t = TopologySpec(fam, 16).build()
        for rate, pat, seed in ((0.0, "uniform", 0), (0.25, "uniform", 1),
                                (0.9, "transpose", 2), (1.0, "hotspot", 3)):
            both(t, f"{fam}_16 {pat} {rate}", inj_rate=rate, pattern=pat,
                 seed=seed, **base)
        both(TopologySpec(fam, 64).build(), f"{fam}_64 paper locality",
             inj_rate=0.6, seed=7, **sim.PAPER_LOCALITY, **base)
    morph = TopologySpec("ring_mesh", 16, morphs=(MorphOverlay(
        hl=1, target=0, link_states=(0, 0, 0, 0, 2, 0, 0, 0)),))
    r = both(morph.build(), "ring_mesh_16 morph overlay", inj_rate=0.3,
             seed=4, **base)
    assert r.dropped > 0
    healthy = TopologySpec("flat_mesh", 64)
    repaired = dataclasses.replace(healthy, faults=sample_faults(
        healthy.build(), n_dead_links=3, seed=6))
    both(repaired.build(), "flat_mesh_64 repaired (3 dead links)",
         inj_rate=0.4, seed=5, **base)
    both(topology.build("ring_mesh", 1024), "ring_mesh_1024 paper locality",
         diag=False, inj_rate=0.625, seed=1, **sim.PAPER_LOCALITY, **base)

    t = TopologySpec("ring_mesh", 64).build()
    cfgs = sweep.grid(inj_rates=(0.25, 0.9), patterns=("uniform", "tornado"),
                      seeds=(0, 3), cycles=250, warmup=50, backend="cuda")
    batched = sweep.sweep(t, cfgs)
    for cfg, rb in zip(cfgs, batched):
        rp = sim.simulate(t, cfg)
        rt = sim.simulate(t, dataclasses.replace(cfg, backend="torch"))
        assert rb == rp and fields(rb) == fields(rt), cfg
        err = max(err, result_err(rb, rt))
    say(2, f"batched sweep of {len(cfgs)} points == per-point kernel runs "
           f"== twin")
    err = max(err, forced_clusters())
    return err


def forced_clusters() -> float:
    """Every kernel mode at 64 PEs split over clusters of 2, 3 and 8 CTAs
    (the main path picks 1 there): kernel == twin on the card."""
    from repro_torch import trace as tr
    from repro_torch.core import sim
    from repro_torch.core.spec import TopologySpec
    from repro_torch.faults import sample_faults
    from repro_torch.kernels import noc_step

    err = 0.0
    topo = TopologySpec("ring_mesh", 64, src_queue_depth=8).build()
    geom = sim.build_geometry(topo, "cuda")
    faults = sample_faults(topo, n_dead_links=3, seed=2)
    schedule = next(iter(tr.traces_for_schedules(64).values()))
    cases = {
        "statistical": [sim.SimConfig(inj_rate=r, seed=s, cycles=250,
                                      warmup=50, **sim.PAPER_LOCALITY)
                        for r, s in ((0.4, 1), (0.9, 2))],
        "faults": [sim.SimConfig(inj_rate=0.6, seed=3, cycles=250,
                                 warmup=50, faults=faults)],
        "trace": [sim.SimConfig(inj_rate=1.0, seed=1, cycles=400, warmup=0,
                                pattern=schedule)],
        "trace+faults": [sim.SimConfig(inj_rate=1.0, seed=4, cycles=400,
                                       warmup=0, pattern=schedule,
                                       faults=faults)],
    }
    for label, cfgs in cases.items():
        c0 = cfgs[0]
        points = [sim.make_point(c, topo.n_pes, topo) for c in cfgs]
        inj, dst, trace, flt, fault_u = sim.batch_operands(
            points, topo.n_pes, c0.cycles, "cuda")
        kw = dict(warmup=c0.warmup, starvation_limit=c0.starvation_limit,
                  arb_iters=sim.ARB_ITERS, trace=trace, faults=flt,
                  fault_u=fault_u, diagnostics=True)
        want = noc_step.run_plain(geom, inj, dst, **kw)
        for c in (2, 3, 8):
            got = noc_step.run_fused(geom, inj, dst, cluster_size=c, **kw)
            for x, y in zip(got, want):
                assert torch.equal(x, y), (label, c)
                if x.numel():
                    err = max(err, float((x.long() - y.long()).abs().max()))
        say(2, f"ring_mesh_64 {label} on clusters of 2, 3 and 8 CTAs: "
               f"kernel == twin (passes {want[3].tolist()})")
    return err


def main_path_experiments():
    from repro_torch.configs.ringmesh_noc import CONFIG
    with open(REFERENCE) as f:
        ref = json.load(f)
    recipe = ref["recipe"]
    cfg = dataclasses.replace(
        CONFIG, injection_rates=tuple(recipe["injection_rates"]),
        cycles=recipe["cycles"], warmup=recipe["warmup"])
    return cfg.experiments(sizes=(256, 1024), seed=recipe["seed"]), ref


def phase_main_path():
    from repro_torch import telemetry
    from repro_torch.core.experiment import run_experiments
    from repro_torch.kernels import noc_step, streams

    exps, ref = main_path_experiments()
    telemetry.drain()
    t0 = time.perf_counter()
    reports = run_experiments(exps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = noc_step.launches()[noc_step.STATISTICAL]
    draws = streams.launches()
    say(3, f"run_experiments: {len(exps)} points, {launches} noc_step "
           f"launches, {draws[streams.FUSED]} stream kernel launches, "
           f"{wall:.3f} s host wall clock incl. geometry and stream setup "
           f"[{CARD}]")
    assert launches > 0, "the main path never launched the kernel"
    assert draws == {streams.FUSED: launches, streams.PLAIN: 0}, draws
    check_main_path(exps, reports, ref)
    say(3, f"all {len(reports)} SimResults equal the reference's "
           f"(jax {ref['jax_version']}) field for field")
    for n in sorted({r.experiment.topology.n_pes for r in reports}):
        for fam in ("ring_mesh", "flat_mesh"):
            rs = [r for r in reports if r.experiment.topology.n_pes == n
                  and r.experiment.topology.family == fam]
            lat = sum(r.sim.avg_latency for r in rs) / len(rs)
            thr = sum(r.sim.throughput for r in rs) / len(rs)
            row = {"n_pes": n, "topology": fam,
                   "avg_latency": round(lat, 1),
                   "avg_throughput": round(thr, 1)}
            assert row in ref["figs15_17_rows"], row
            r0 = rs[0]
            say(3, f"figs15_17 {json.dumps(row)} | power "
                   f"{r0.power.total_w:.3f} W (activity "
                   f"{r0.power.activity:.4f}, {r0.experiment.traffic.kind})"
                   f" | area {r0.area.lut} LUT | diameter "
                   f"{r0.analytic.diameter}")
    return launches, draws[streams.FUSED]


def check_main_path(exps, reports, ref) -> None:
    """Every report of the main path equals the reference's point."""
    want = {(p["family"], p["n_pes"], p["pattern"]): p
            for p in ref["points"]}
    for e, r in zip(exps, reports):
        p = want[(e.topology.family, e.topology.n_pes, e.traffic.kind)]
        got = {k: getattr(r.sim, k) for k in p
               if k not in ("family", "n_pes", "pattern")}
        exp = {k: v for k, v in p.items()
               if k not in ("family", "n_pes", "pattern")}
        # `lost` included: the reference's fixpoint leaves residue at
        # flat_mesh_1024 under bit_reversal/transpose, and so must the port.
        assert got == exp, (e.topology.name, e.traffic.kind, got, exp)


def bound_ms(geom, batch: int, cycles: int, passes, n_phases: int = 0,
             n_faults: int = 0, moved: int = 0) -> tuple[float, str]:
    """Least time for one launch: the larger of the bytes it must move
    over the memory rate and its scalar operations over the scalar rate.
    Operations count what this run's data needed: the arbitration passes
    are the kernel's own count, and the fault checks on moved flits use
    the run's own count of moves."""
    lp1, p = geom.route.shape
    np1, fc = geom.cand.shape
    fi = geom.intab.shape[1]
    stream = batch * cycles * p * 3            # inj bool + dst int16
    tables = (lp1 * p * 2 + lp1 * (5 * 4 + 1) + p * 4 + np1 * fc * 4
              + lp1 * fi * 4)
    outputs = batch * (lp1 * 4 + 8 * 4 + 24 * 4 + 4)
    # Trace replay: the phase tables (dst and flits [n_phases, P], totals
    # [n_phases]) in, the completion cycles [n_phases] out.  Faults: the
    # [cycles, F] float32 draws and the [F] entries in.
    trace_bytes = batch * n_phases * (2 * p * 4 + 4 + 4)
    fault_bytes = batch * (cycles * n_faults * 4 + n_faults * 12)
    nbytes = stream + tables + outputs + trace_bytes + fault_bytes
    # Per cycle and row: route and score (12), dequeue and counts (14),
    # fan-in enqueue and injection (4 per entry + 12).  Per arbitration
    # pass: the channel row-max (4 per candidate + 2), winners, feasibility
    # and the active update (12 per row).  Trace: the phase gate and the
    # sent count per PE (4) and the barrier update (10) per cycle.
    # Faults: the active flag of each entry (3) per cycle, and a compare
    # with every entry (2) per moved flit.
    per_cycle = lp1 * (12 + 14 + 4 * fi + 12)
    if n_phases:
        per_cycle += 4 * p + 10
    per_cycle += 3 * n_faults
    per_pass = np1 * (4 * fc + 2) + lp1 * 12
    ops = (batch * cycles * per_cycle + int(passes.sum()) * per_pass
           + 2 * n_faults * moved)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_launch(phase: int, topo, cfgs, reps: int) -> dict:
    """One launch of the path on ``topo``: the wrapper's output held
    against the plain version on the same inputs, then both timed with
    CUDA events (the kernel after a warm-up, over ``reps`` launches)."""
    from repro_torch.core import sim
    from repro_torch.kernels import noc_step

    c0 = cfgs[0]
    geom = sim.build_geometry(topo, "cuda")
    points = [sim.make_point(c, topo.n_pes, topo) for c in cfgs]
    inj, dst, trace, faults, fault_u = sim.batch_operands(
        points, topo.n_pes, c0.cycles, "cuda")
    kw = dict(warmup=c0.warmup, starvation_limit=c0.starvation_limit,
              arb_iters=sim.ARB_ITERS, trace=trace, faults=faults,
              fault_u=fault_u, strict_barrier=c0.strict_barrier,
              watchdog=c0.watchdog)
    got = noc_step.run_fused(geom, inj, dst, **kw)        # warm-up
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        noc_step.run_fused(geom, inj, dst, **kw)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    start.record()
    want = noc_step.run_plain(geom, inj, dst, **kw)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    err = 0.0
    for x, y in zip(got, want):
        assert torch.equal(x, y), topo.name
        if x.numel():
            err = max(err, float((x.long() - y.long()).abs().max()))
    n_phases = 0 if trace is None else trace[0].shape[1]
    n_faults = 0 if faults is None else faults[0].shape[1]
    moved = int(got[1][:, noc_step.MOVED].sum())
    b_ms, by = bound_ms(geom, len(cfgs), c0.cycles, got[3], n_phases,
                        n_faults, moved)
    modes = "+".join(noc_step.launch_modes(trace, faults))
    cluster, nbytes = noc_step.plan_for(geom, trace, faults)
    lp1, np1 = geom.route.shape[0], geom.cand.shape[0]
    assert noc_step.kernel_shared_bytes(
        -(-lp1 // cluster), -(-np1 // cluster), geom.depth, topo.n_pes,
        n_faults, n_phases) == nbytes, (topo.name, nbytes)
    cost = barrier_cost(cluster)
    resident = noc_step.max_active_clusters(cluster, nbytes)
    assert resident >= 1, (topo.name, cluster, nbytes)
    if cluster > 1 and phase == 4:
        share = noc_step.remote_share(geom, cluster)
        say(phase, f"{topo.name}: {resident} clusters of {cluster} fit the "
                   f"card at once; share of route hops whose target "
                   f"channel / next queue sits in another CTA: "
                   f"{share['channel']:.3f} / {share['next_row']:.3f}")
    say(phase, f"{topo.name} {modes}: L+1={geom.route.shape[0]} "
               f"batch={len(cfgs)} cycles={c0.cycles} phases={n_phases} "
               f"fault entries={n_faults} | cluster C={cluster}, "
               f"{nbytes} B shared per CTA, barrier {cost['ns']:.1f} ns "
               f"| kernel {ms:.3f} ms/launch "
               f"({ms * 1e3 / c0.cycles / len(cfgs):.3f} us per cycle per "
               f"point) | twin on the card {plain_ms:.1f} ms | bound "
               f"{b_ms:.4f} ms ({by}) | arbitration passes "
               f"{got[3].tolist()} | kernel == twin [{CARD}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "by": by,
            "err": err}


def summed(rows: list[dict]) -> dict:
    by = {r["by"] for r in rows}
    return {"ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "err": max(r["err"] for r in rows)}


def path_groups(exps, modes=None):
    """(topology, configs) of each launch ``run_experiments`` makes for
    ``exps`` (one per geometry and batch shape), in order; with ``modes``,
    only the launches that run one of those kernel modes."""
    from repro_torch.core import sweep, traffic
    from repro_torch.kernels import noc_step

    by_spec: dict = {}
    for e in exps:
        by_spec.setdefault(e.topology, []).append(e.sim_config())
    out = []
    for spec, cfgs in by_spec.items():
        topo = spec.build()
        for idxs in sweep._grouped(topo, cfgs).values():
            group = [cfgs[i] for i in idxs]
            c0 = group[0]
            launch = noc_step.launch_modes(
                True if traffic.resolve(c0.pattern).is_trace else None,
                c0.faults or None)
            if modes is None or set(launch) & set(modes):
                out.append((topo, group))
    return out


def phase_times():
    """Kernel vs twin on the main path's own shapes, timed; then where a
    launch's time goes: the same launch held to one arbitration pass a
    cycle, and split over a cluster of 8 CTAs."""
    exps, _ = main_path_experiments()
    groups = path_groups(exps)
    rows = [time_launch(4, topo, cfgs, reps=5) for topo, cfgs in groups]
    for topo, cfgs in groups:
        variant_times(topo, cfgs)
    return summed(rows)


def streams_bound_ms(points, cycles: int) -> tuple[float, str]:
    """Least time for one launch of the streams kernel over ``points``:
    the larger of the bytes it moves (its table in, the streams out) over
    the memory rate and the instructions of its hashes over the
    instruction rate.  An element takes 6 hashes (injection 1, locality
    1, ringlet 2, block 2), 8 on a point of uniform destinations (the
    offset 2); a fault draw takes 1."""
    from repro_torch.kernels import streams
    p, n_faults = len(points[0].perm_dst), points[0].fault_links.shape[0]
    hashes = sum(cycles * (p * (6 if pt.use_perm else 8) + n_faults)
                 for pt in points)
    nbytes = len(points) * (cycles * (p * 3 + n_faults * 4) + 4 * (p + streams.HEADER))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = hashes * HASH_INSTRUCTIONS / INSTRUCTIONS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_stream_times(reps: int = 20) -> dict:
    """The streams kernel against its plain version on the card, bit for
    bit, on the paper's grid (12 points at 1024 PEs x 1500 cycles, each
    with its own seed) and on the same points carrying 8 fault entries;
    the kernel's launch and the plain version timed with CUDA events."""
    from repro_torch.configs.ringmesh_noc import CONFIG
    from repro_torch.core import sim
    from repro_torch.kernels import streams

    seeds = [1, 0, 2**31 - 1, -1, -2**31, 7, 1234567, -98765, 26, 3, 42, 5]
    exps = CONFIG.experiments(sizes=(1024,), families=("ring_mesh",))
    assert len(exps) == len(seeds), len(exps)
    healthy = [sim.make_point(dataclasses.replace(e.sim_config(), seed=s),
                              1024) for e, s in zip(exps, seeds)]
    faulted = [dataclasses.replace(
        pt, fault_links=np.zeros(8, np.int32),
        fault_drop_p=np.zeros(8, np.float32),
        fault_onset=np.zeros(8, np.int32)) for pt in healthy]
    dev, cycles = torch.device("cuda"), CONFIG.cycles
    rows = {}
    for label, points in (("grid", healthy), ("grid, F = 8", faulted)):
        got = streams.draw(points, 1024, cycles, dev)
        want = sim._draw_streams_plain(points, 1024, cycles, dev)
        assert torch.equal(got[0], want[0]), label
        assert torch.equal(got[1], want[1]), label
        assert (got[2] is None) == (want[2] is None), label
        if want[2] is not None:
            assert torch.equal(got[2].view(torch.int32),
                               want[2].view(torch.int32)), label
        table = torch.from_numpy(streams.point_table(points, 1024)).to(dev)
        ms = event_ms(lambda: streams.launch(table, *got), reps)
        plain_ms = event_ms(lambda: sim._draw_streams_plain(
            points, 1024, cycles, dev), 1)
        b_ms, by = streams_bound_ms(points, cycles)
        rows[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": by, "err": 0.0}
        say(4, f"streams kernel, {label}: {len(points)} points x {cycles} "
               f"cycles x 1024 PEs, kernel == plain version in all three "
               f"outputs | kernel {ms:.4f} ms/launch, plain version on the "
               f"card {plain_ms:.1f} ms | bound {b_ms:.4f} ms ({by}; "
               f"{100 * b_ms / ms:.1f} % of it) [{CARD}]")
    return rows["grid"]


def variant_times(topo, cfgs, reps: int = 3) -> None:
    """Device ms of the launch on ``topo`` with ``arb_iters=1`` (the
    cycle's fixed stages and one pass) and with ``cluster_size=8``; their
    results are not the simulator's and are not kept."""
    from repro_torch.core import sim
    from repro_torch.kernels import noc_step

    c0 = cfgs[0]
    geom = sim.build_geometry(topo, "cuda")
    points = [sim.make_point(c, topo.n_pes, topo) for c in cfgs]
    inj, dst, trace, faults, fault_u = sim.batch_operands(
        points, topo.n_pes, c0.cycles, "cuda")
    kw = dict(warmup=c0.warmup, starvation_limit=c0.starvation_limit,
              trace=trace, faults=faults, fault_u=fault_u)
    one = event_ms(lambda: noc_step.run_fused(geom, inj, dst, arb_iters=1,
                                              **kw), reps)
    eight = event_ms(lambda: noc_step.run_fused(
        geom, inj, dst, arb_iters=sim.ARB_ITERS, cluster_size=8, **kw), reps)
    say(4, f"{topo.name}: one arbitration pass a cycle {one:.3f} ms/launch "
           f"({one * 1e3 / c0.cycles:.2f} us per cycle of the launch); all "
           f"passes on clusters of 8 CTAs {eight:.3f} ms/launch (the "
           f"planner picks C={noc_step.plan_for(geom)[0]}) [{CARD}]")


# ---------------------------------------------------------------------------
def _spec(family: str, n: int, depth: int):
    from repro_torch.core.spec import TopologySpec
    return TopologySpec(family, n, src_queue_depth=depth)


def trace_grid(ref, sizes, backend: str):
    """The trace_replay recipe: one ``run_grid`` per (size, family), the
    three schedules as its traffic axis.  Returns (tags, reports)."""
    from repro_torch import trace as tr
    from repro_torch.core.experiment import Budget, Experiment

    r = ref["recipes"]["trace_replay"]
    depth = ref["recipes"]["src_queue_depth"]
    tags, reports = [], []
    for n in sizes:
        traces = tr.traces_for_schedules(
            n, pod_size=r["pod_size"], algorithm=r["algorithm"],
            normalize_flits=r["normalize_flits"])
        budget = Budget(cycles=r["cycles"][str(n)], warmup=0,
                        backend=backend)
        for fam in ("ring_mesh", "flat_mesh"):
            exp = Experiment(topology=_spec(fam, n, depth),
                             traffic=next(iter(traces.values())),
                             budget=budget, inj_rate=r["inj_rate"],
                             seed=r["seed"])
            reports += exp.run_grid(traffics=tuple(traces.values()))
            tags += [(fam, n, sched) for sched in traces]
    return tags, reports


def watchdog_demo(ref, backend: str):
    from repro_torch import trace as tr
    from repro_torch.core.experiment import Budget, Experiment
    from repro_torch.faults import FaultSpec

    w = ref["recipes"]["watchdog"]
    trace = tr.from_records(w["n_pes"], w["phases"])
    out = {}
    for mode, strict, wd in (("strict", True, w["watchdog"]),
                             ("lenient", False, 0)):
        out[mode] = Experiment(
            topology=_spec("ring_mesh", w["n_pes"],
                           ref["recipes"]["src_queue_depth"]),
            traffic=trace,
            budget=Budget(cycles=w["cycles"], warmup=0,
                          strict_barrier=strict, watchdog=wd,
                          backend=backend),
            inj_rate=1.0,
            faults=FaultSpec(dead_routers=tuple(w["dead_routers"]))).run()
    return out


def phase_trace(ref) -> tuple[int, float, list]:
    """Trace replay at full width.  Returns (trace-mode launches of the
    path, largest kernel-vs-twin difference, the path's experiments)."""
    from repro_torch import telemetry
    from repro_torch.kernels import noc_step

    want = {(p["family"], p["n_pes"], p["schedule"]): p
            for p in ref["trace_replay"]}
    with open(BENCH) as f:
        bench = {(row["topology"], row["n_pes"], row["schedule"]): row
                 for row in json.load(f)["tables"]["trace_replay"]["rows"]}
    sizes = ref["recipes"]["trace_replay"]["sizes"]
    telemetry.drain()
    with host_clock(clocked_targets()) as spent:
        t0 = time.perf_counter()
        tags, reports = trace_grid(ref, sizes, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = noc_step.launches()[noc_step.TRACE]
    say(5, f"run_grid over {len(reports)} trace points: launches by mode "
           f"{noc_step.launches()}, {host_split(wall, spent)} [{CARD}]")
    assert launches > 0, "the trace path never launched the kernel's mode"
    for tag, rep in zip(tags, reports):
        assert as_reference(rep.sim) == {
            k: v for k, v in want[tag].items()
            if k not in ("family", "schedule")}, tag
        row = bench[tag]
        assert (rep.completion_cycles, rep.sim.delivered) == (
            row["completion_cycles"], row["delivered"]), (tag, row)
        say(5, f"{tag}: {rep.sim.n_phases} phases, completion "
               f"{rep.completion_cycles} cycles, delivered "
               f"{rep.sim.delivered} == reference == BENCH_noc.json")
    say(5, f"all {len(reports)} points equal the reference (jax "
           f"{ref['jax_version']}) field for field, phase_done included, "
           f"and all {len(bench)} BENCH_noc.json trace_replay rows "
           f"reproduce")
    err = 0.0
    small = [n for n in sizes if n <= 256]
    kernel = [(t, r) for t, r in zip(tags, reports) if t[1] in small]
    _, twin = trace_grid(ref, small, "torch")
    for (tag, a), b in zip(kernel, twin):
        assert fields(a.sim) == fields(b.sim), tag
        err = max(err, result_err(a.sim, b.sim))
    say(5, f"kernel == twin on the card over the {len(twin)} points at "
           f"{small} PEs")
    demo = watchdog_demo(ref, "cuda")
    demo_twin = watchdog_demo(ref, "torch")
    for p in ref["watchdog"]:
        got = demo[p["mode"]].sim
        assert as_reference(got) == {k: v for k, v in p.items()
                                     if k != "mode"}, p["mode"]
        assert fields(got) == fields(demo_twin[p["mode"]].sim)
        err = max(err, result_err(got, demo_twin[p["mode"]].sim))
    strict, lenient = demo["strict"].sim, demo["lenient"].sim
    assert (list(strict.phase_done), strict.stall_unretired,
            strict.stalled_phase, strict.stall_cycle) == ([5, -76], 4, 1, 74)
    assert list(lenient.phase_done) == [5, 10] and lenient.dropped == 4
    say(5, f"watchdog demo: strict phase_done {list(strict.phase_done)}, "
           f"phase {strict.stalled_phase} stalled at cycle "
           f"{strict.stall_cycle} with {strict.stall_unretired} unretired "
           f"credits; lenient {list(lenient.phase_done)} with "
           f"{lenient.dropped} drops; kernel == twin == reference")
    return launches, err, [r.experiment for r in reports]


MOE_CELL = os.path.join(ROOT, "noc_bench", "configs",
                        "deepseek_v3-ring_mesh-1024.json")
MOE_MIX = os.path.join(ROOT, "noc_bench", "traffic", "moe_decode.json")
MOE_ROUTER = ("hidden_size", "n_routed_experts", "num_experts_per_tok",
              "n_group", "topk_group", "routed_scaling_factor",
              "norm_topk_prob")
# (MoE layer, router seed, token seed) of each exchange phase 5 checks.
MOE_EXCHANGES = ((3, 2 ** 31 - 1, 17), (60, 2 ** 40 + 3, 2 ** 31 - 9))


def phase_records(tokens_per_pe: int | None = None) -> dict:
    """The trace mode's record walk at the MoE cell's size: a DeepSeek-V3
    layer's dispatch and combine on the 1024-PE ring-mesh (its fabric,
    tokens a PE, flit scale and cycle budget from the cell's files), each
    exchange run through ``run_fused`` in records form and through
    ``run_plain`` on the same card tensors, every output equal bit for
    bit, both phases settled inside the budget, then the kernel timed.
    Returns the summed timing row."""
    from repro_torch import telemetry
    from repro_torch.core import sim
    from repro_torch.core.spec import TopologySpec
    from repro_torch.kernels import noc_step
    from repro_torch.trace import extract

    with open(MOE_CELL) as f:
        cell = json.load(f)
    with open(MOE_MIX) as f:
        mix = json.load(f)
    fab, fl = cell["fabric"], mix["flits"]
    tokens = tokens_per_pe or mix["tokens_per_pe"]
    cycles = mix["budget"]["cycles"]
    topo = TopologySpec(fab["family"], fab["n_pes"],
                        queue_depth=fab["queue_depth"],
                        src_queue_depth=fab["src_queue_depth"]).build()
    geom = sim.build_geometry(topo, "cuda")
    rows = []
    for layer, router_seed, token_seed in MOE_EXCHANGES:
        trace, summary = extract.moe_exchange_trace(
            {k: cell[k] for k in MOE_ROUTER}, topo.n_pes, tokens,
            dispatch_bytes=cell["token_bytes"]["dispatch"],
            combine_bytes=cell["token_bytes"]["combine"],
            router_seed=router_seed, token_seed=token_seed, device="cuda",
            flit_bytes=fl["flit_bytes"], scale=fl["scale"])
        cfg = sim.SimConfig(cycles=cycles, warmup=0, inj_rate=1.0,
                            pattern=trace, seed=token_seed,
                            starvation_limit=cell["starvation_limit"],
                            device="cuda")
        point = sim.make_point(cfg, topo.n_pes, topo)
        inj, dst, tables, _, _ = sim.batch_operands(
            [point], topo.n_pes, cycles, "cuda")
        assert len(tables) == 6, "the exchange did not take records form"
        kw = dict(warmup=0, starvation_limit=cfg.starvation_limit,
                  arb_iters=sim.ARB_ITERS, trace=tables)
        telemetry.drain()
        got = noc_step.run_fused(geom, inj, dst, **kw)
        launched = noc_step.launches()
        assert launched == {noc_step.STATISTICAL: 0, noc_step.TRACE: 1,
                            noc_step.FAULTS: 0}, launched
        start, stop = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        start.record()
        want = noc_step.run_plain(geom, inj, dst, **kw)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        assert len(got) == len(want) == 5
        for x, y in zip(got, want):
            assert torch.equal(x, y), (layer, router_seed, token_seed)
        done = got[4][0].tolist()
        flits = (sum(summary["dispatch_flits"])
                 + sum(summary["combine_flits"]))
        delivered = int(got[1][0, noc_step.DELIVERED])
        assert min(done) >= 0, f"a phase did not settle in {cycles}: {done}"
        assert delivered == flits and int(got[0].sum()) == 0, (
            delivered, flits)
        start.record()
        for _ in range(3):
            noc_step.run_fused(geom, inj, dst, **kw)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / 3
        b_ms, by = bound_ms(geom, 1, cycles, got[3], 2)
        cluster, nbytes = noc_step.plan_for(geom, tables)
        say(5, f"MoE layer {layer} at {tokens} tokens a PE: "
               f"{trace.trace.n_records} records (at most "
               f"{trace.trace.max_records_per_source()} a source a phase), "
               f"largest expert {max(summary['expert_tokens'])} tokens, "
               f"{flits} flits; phases done at {done} of {cycles} cycles "
               f"| C={cluster}, {nbytes} B shared per CTA | kernel "
               f"{ms:.3f} ms ({ms * 1e3 / cycles:.3f} us a cycle, "
               f"{int(got[3][0]) / cycles:.2f} passes a cycle) | twin on "
               f"the card {plain_ms:.1f} ms | bound {b_ms:.4f} ms ({by}, "
               f"record tables left out) | one trace-mode launch, kernel "
               f"== twin [{CARD}]")
        rows.append({"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "by": by, "err": 0.0})
    return summed(rows)


def fault_grid(ref, sizes, backend: str):
    """The fault_tolerance recipe as Experiments: (tags, experiments)."""
    from repro_torch.core.experiment import Budget, Experiment
    from repro_torch.faults import sample_faults, suggest_repair_morph

    r = ref["recipes"]["fault_tolerance"]
    depth = ref["recipes"]["src_queue_depth"]
    tags, exps = [], []
    for n in sizes:
        budget = Budget(cycles=r["cycles"][str(n)], warmup=0,
                        backend=backend)
        inj = r["inj_rate"][str(n)]
        for fam in ("ring_mesh", "flat_mesh"):
            spec = _spec(fam, n, depth)
            topo = spec.build()
            scen = {(c, s): sample_faults(topo, n_dead_links=c, seed=s)
                    for c in r["counts"] for s in r["seeds"]}
            exps.append(Experiment(topology=spec, budget=budget,
                                   inj_rate=inj, seed=r["seed"]))
            tags.append((fam, n, "healthy", 0, 0, None))
            for (c, s), f in scen.items():
                exps.append(Experiment(topology=spec, budget=budget,
                                       inj_rate=inj, seed=r["seed"],
                                       faults=f))
                tags.append((fam, n, "faulted", c, s, f))
            rc, rs = r["repair_count"], r["seeds"][0]
            exps.append(Experiment(
                topology=suggest_repair_morph(spec, scen[(rc, rs)]),
                budget=budget, inj_rate=inj, seed=r["seed"]))
            tags.append((fam, n, "repaired", rc, rs, scen[(rc, rs)]))
    return tags, exps


def phase_faults(ref) -> tuple[int, float, list, dict]:
    """Runtime faults at 256 and 1024 PEs.  Returns (fault-mode launches
    of the path, largest kernel-vs-twin difference, the experiments, the
    reports by (family, n, mode, dead links, fault seed))."""
    from repro_torch import telemetry
    from repro_torch.core import sim
    from repro_torch.core.experiment import run_experiments
    from repro_torch.faults import FaultSpec, LinkFault, sample_faults
    from repro_torch.kernels import noc_step

    want = {(p["family"], p["n_pes"], p["mode"], p["n_dead_links"],
             p["fault_seed"]): p for p in ref["fault_tolerance"]}
    skip = ("family", "mode", "n_dead_links", "fault_seed", "faults")

    def check(tags, reports):
        for (fam, n, mode, c, s, f), rep in zip(tags, reports):
            p = want[(fam, n, mode, c, s)]
            assert (f.to_dict() if f else None) == p["faults"], (fam, n, c)
            r = rep.sim
            assert as_reference(r) == {k: v for k, v in p.items()
                                       if k not in skip}, (fam, n, mode, c)
            assert r.offered == r.delivered + r.dropped + r.in_flight, (
                fam, n, mode, c, s)

    tags, exps = fault_grid(ref, (256, 1024), "cuda")
    telemetry.drain()
    with host_clock(clocked_targets()) as spent:
        t0 = time.perf_counter()
        reports = run_experiments(exps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = noc_step.launches()[noc_step.FAULTS]
    say(6, f"run_experiments over {len(exps)} points: launches by mode "
           f"{noc_step.launches()}, {host_split(wall, spent)} [{CARD}]")
    assert launches > 0, "the fault path never launched the kernel's mode"
    check(tags, reports)
    for tag, rep in zip(tags, reports):
        if tag[2] != "faulted" or tag[3] == 8:
            say(6, f"{tag[:5]}: reachability {rep.reachability:.4f}, "
                   f"delivered fraction {rep.delivered_fraction:.4f}, "
                   f"dropped {rep.sim.dropped}")
    say(6, f"all {len(reports)} points equal the reference (jax "
           f"{ref['jax_version']}) field for field; offered == delivered "
           f"+ dropped + in_flight at every point")

    err = 0.0
    tags64, k64 = fault_grid(ref, (64,), "cuda")
    _, t64 = fault_grid(ref, (64,), "torch")
    kr, tr_ = run_experiments(k64), run_experiments(t64)
    check(tags64, kr)
    for tag, a, b in zip(tags64, kr, tr_):
        assert fields(a.sim) == fields(b.sim), tag
        err = max(err, result_err(a.sim, b.sim))
    spec = _spec("ring_mesh", 64, ref["recipes"]["src_queue_depth"])
    topo = spec.build()
    chans = sample_faults(topo, n_dead_links=3, seed=9).dead_links
    late = FaultSpec(dead_links=chans[:1], transient=(
        LinkFault(link=chans[1], drop_p=0.5, onset=250),
        LinkFault(link=chans[2], drop_p=1.0, onset=400)))
    kw = dict(cycles=800, warmup=0, inj_rate=0.3, seed=4, faults=late)
    a = sim.simulate(topo, sim.SimConfig(backend="cuda", **kw))
    b = sim.simulate(topo, sim.SimConfig(backend="torch", device="cuda",
                                         **kw))
    assert fields(a) == fields(b) and a.lost == 0
    assert a.offered == a.delivered + a.dropped + a.in_flight
    err = max(err, result_err(a, b))
    say(6, f"kernel == twin on the card over the {len(k64)} points of the "
           f"64-PE recipe (which equal the reference too) and a transient "
           f"fault with onsets 250/400 (dropped {a.dropped})")
    return launches, err, exps, {t[:5]: r for t, r in zip(tags, reports)}


# ---------------------------------------------------------------------------
# Phases 8-11: the model zoo's path on zamba2-1.2b and its two kernels.
# ---------------------------------------------------------------------------
DEVICE = "cuda"
ARCH = "zamba2-1.2b"
# The CPU tests' matrices (tests/test_torch_attention_ssd.py, after the
# reference's tests/test_kernels.py): attention (B, Hq, Hkv, Sq, Skv, D,
# causal, window, block_q, block_k) and SSD (B, H, G, S, P, N, chunk).
ATTN_CASES = [
    (1, 2, 2, 128, 128, 64, True, None, 64, 64),
    (2, 4, 2, 128, 128, 64, True, None, 64, 64),
    (1, 8, 1, 128, 128, 32, True, None, 32, 64),
    (1, 2, 2, 128, 128, 64, False, None, 64, 64),
    (1, 4, 4, 256, 256, 64, True, 64, 64, 64),
    (1, 4, 2, 256, 256, 64, True, 100, 64, 64),
    (2, 4, 2, 1, 256, 64, True, None, 1, 64),
    (1, 4, 4, 64, 256, 64, True, None, 32, 64),
    (1, 2, 2, 128, 128, 128, True, None, 128, 128),
]
SSD_CASES = [
    (1, 2, 1, 64, 32, 16, 16),
    (2, 4, 2, 128, 32, 16, 32),
    (1, 4, 1, 128, 64, 32, 64),
    (1, 8, 8, 64, 16, 16, 16),
    (1, 2, 1, 128, 32, 16, 128),
]
# Full-width shapes.  The first of each is the main path's: Zamba2 scoring
# a batch of 2 x 4096 tokens (32 MHA heads of width 64; 64 SSD heads of
# width 64, d_state 64, one group, chunk 128).  Then h2o-danube-1.8b's
# GQA 32/8, width 80, a 4096 window, queries at the tail of an 8192 kv;
# the Qwen width 128 with GQA 28/4; and the scoring shapes of phase 13:
# qwen2-7b's 2 x 4096 tokens and h2o-danube-1.8b's 1 x 8192, where the
# window binds.
FLASH_SHAPES = [
    ("zamba2 scoring", (2, 32, 32, 4096, 4096, 64, True, None)),
    ("h2o-danube window 4096, offset 4096", (1, 32, 8, 4096, 8192, 80, True,
                                             4096)),
    ("qwen d128", (1, 28, 4, 2048, 2048, 128, True, None)),
    ("qwen2-7b scoring", (2, 28, 4, 4096, 4096, 128, True, None)),
    ("h2o-danube scoring", (1, 32, 8, 8192, 8192, 80, True, 4096)),
]
# The cross-attention models' lengths, none of which tiles by the kernel's
# 128-row tiles (the kernel masks the ragged tails): whisper-small's
# encoder over 16 x 1 500 frames, its cross-attention (448 decoder rows
# over the frames) and causal decoder self-attention, the vision model's
# cross-attention (GQA 32/8, width 128, 2 x 4 096 rows over 1 600 image
# tokens) and one cross decode row over whisper's frames.
RAGGED_FLASH_SHAPES = [
    ("whisper encoder", (16, 12, 12, 1500, 1500, 64, False, None)),
    ("whisper cross", (16, 12, 12, 448, 1500, 64, False, None)),
    ("whisper decoder self", (16, 12, 12, 448, 448, 64, True, None)),
    ("vision cross", (2, 32, 8, 4096, 1600, 128, False, None)),
    ("cross decode row", (16, 12, 12, 1, 1500, 64, False, None)),
]
# The SSD at mamba2-1.3b's d_state 128 (N 128, P 64, chunk 128): 8 heads
# x 512 steps, and its scoring shape (2 x 4096 tokens, 64 heads).  Both
# also run in float32, where the scalar kernel splits P over k blocks.
SSD_SHAPES = [("zamba2 scoring", (2, 64, 1, 4096, 64, 64, 128)),
              ("mamba2-1.3b d_state 128", (1, 8, 1, 512, 64, 128, 128)),
              ("mamba2-1.3b scoring", (2, 64, 1, 4096, 64, 128, 128))]
SSD_F32_SHAPES = SSD_SHAPES[1:]
# The scalar-FMA bfloat16 kernels that the tensor-core ones replaced, at
# the same shapes (PERF.md's kernel table, earlier times; NVIDIA H100 80GB
# HBM3, 700.00 W), printed beside the current kernels.
SCALAR_FLASH_MS = {"zamba2 scoring": 10.465,
                 "h2o-danube window 4096, offset 4096": 12.778,
                 "qwen d128": 2.705}
SCALAR_SSD_MS = {"zamba2 scoring": 3.084}
SCORE_BATCH, SCORE_SEQ = 2, 4096
SERVE = dict(n_slots=4, max_seq=512, n_requests=6, prompt=(64, 256),
             new_tokens=(16, 32), seed=11)
# Kernel vs plain version, |got - want| <= atol + rtol * |want| elementwise
# (atol = rtol): attention 2e-5 in float32 (summation order; a softmax
# mean has no cancellation); the SSD 3e-4 in float32 (another float32
# cumsum and product order, carried through exp, on outputs that are sums
# of terms far larger than themselves; the reference's own tolerance
# between SSD algorithms); both 2e-2 in bfloat16 (outputs rounded to
# bfloat16 on each side; the bfloat16 attention kernel also rounds the
# softmax probabilities to bfloat16 as the operand of its P V product, as
# every flash kernel on tensor cores does, while the plain version keeps
# them in float32).
TOL = {("flash_attention", torch.float32): 2e-5,
       ("flash_attention", torch.bfloat16): 2e-2,
       ("ssd_scan", torch.float32): 3e-4,
       ("ssd_scan", torch.bfloat16): 2e-2}
# The full-width scoring path, kernels vs the plain route.  They differ
# only where a kernel and its plain version sum in another order and, in
# bfloat16, round their outputs to another neighbour; 38 layers of random
# weights carry those one-ulp differences into every logit.  In bfloat16
# as shipped: the logits' rms difference within 5 % of their rms, the loss
# within 0.02 (the first full-width run measured 3.2 % and 3.7e-4, and a
# largest single difference of 0.17 among 262 million logits).  With
# float32 compute (COMPUTE_DTYPE set to float32 for the run), where the
# kernels agree with their plain versions to 2e-5 / 3e-4: the logits
# elementwise within 1e-3 + 1e-3 * |plain|, the loss within 1e-3.
SCORE_RMS_TOL, SCORE_LOSS_TOL = 0.05, 0.02
SCORE_F32_TOL = 1e-3
# Phase 16 holds the bfloat16 logits of both routes against the float32-
# compute plain route, the model both approximate: the kernels' route may
# be no farther from it than the plain route is, within 5 %.  The mutual
# 5 % limit above does not hold at the vision model's 40 random layers
# whatever the kernel: the two bfloat16 routes drift apart as the square
# root of depth (on an H100: 1.7 % at 5 layers, 2.5 % at 10, 3.8 % at 20,
# 5.7 % at 40), while each stays as far from the float32 model as the
# other (8.41 % and 8.37 %; whisper 1.208 % and 1.206 %).
FLOAT32_RATIO = 1.05
# Against the JAX reference (tests/data/torch_port_model_reference.json):
# the top-10 logits within 0.125 (four bfloat16 ulps at magnitude 4; the
# plain route on a CPU came within 0.047), loss within 0.01 (CPU: 6e-4).
ANCHOR_LOGIT_TOL, ANCHOR_LOSS_TOL = 0.125, 0.01


def logits_close(label: str, got, want) -> str:
    """Hold logits to the plain route's: ``SCORE_F32_TOL`` elementwise in
    float32, ``SCORE_RMS_TOL`` on the rms difference in bfloat16.  Returns
    a summary of the differences."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rel = float(diff.square().mean().sqrt() / w.square().mean().sqrt())
    argmax = float((g.argmax(-1) != w.argmax(-1)).float().mean())
    msg = (f"max |d logits| {float(diff.max()):.4g}, rms difference "
           f"{rel:.2e} of the rms, argmax differs at {argmax:.2%} of "
           f"{g[..., 0].numel()} positions")
    if got.dtype == torch.float32:
        bad = int((diff > SCORE_F32_TOL * (1 + w.abs())).sum())
        assert bad == 0, (label, msg, bad)
    else:
        assert rel <= SCORE_RMS_TOL, (label, msg)
    return msg


@contextlib.contextmanager
def device_clock(targets):
    """Device ms spent inside each of ``targets`` ((owner, attribute)
    pairs) while the block runs: CUDA events recorded on the stream just
    before and after each call, read after the block."""
    events, saved = {}, []
    for owner, name in targets:
        fn = getattr(owner, name)
        events[name] = []

        def wrapped(*a, _fn=fn, _name=name, **k):
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            start.record()
            out = _fn(*a, **k)
            stop.record()
            events[_name].append((start, stop))
            return out
        saved.append((owner, name, fn))
        setattr(owner, name, wrapped)
    spent: dict = {}
    try:
        yield spent
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    torch.cuda.synchronize()
    for name, pairs in events.items():
        spent[name] = sum(a.elapsed_time(b) for a, b in pairs)


def kernel_counts(cfg) -> dict:
    """Kernel launches one cache-free forward of ``cfg`` makes: one flash
    launch per self-attention, two per cross layer (its self- and its
    cross-attention), one per encoder layer; one SSD launch per Mamba
    block."""
    n = {k: sum(u.count(k) * r for u, r in cfg.stages)
         for k in ("attn", "moe", "cross", "mamba", "hybrid")}
    return {"flash_attention": n["attn"] + n["moe"] + n["hybrid"]
            + 2 * n["cross"] + cfg.encoder_layers,
            "ssd_scan": n["mamba"] + n["hybrid"]}


def launch_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    return {"flash_attention": fa.launches, "ssd_scan": ss.launches}


def reset_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    fa.reset_launches()
    ss.reset_launches()


def free_card() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def model_config():
    from repro_torch import configs
    return configs.get(ARCH)


def check_close(name: str, label: str, got, want) -> float:
    """Hold a kernel's output to its plain version's; returns the largest
    absolute difference."""
    t = TOL[(name, got.dtype)]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bad = diff > t + t * w.abs()
    assert got.shape == want.shape and got.dtype == want.dtype, label
    assert torch.isfinite(g).all(), (name, label, "non-finite output")
    assert not bool(bad.any()), (name, label, float(diff.max()),
                                 int(bad.sum()))
    return float(diff.max())


def event_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``, CUDA events around ``reps`` calls
    after one warm-up call.  A sleep kernel (~5 ms) holds the stream
    first, so that the calls queue behind it and the events time the
    device rather than the host's launch rate (a call of the SSD kernel
    takes less device time than its wrapper takes on the host)."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def visible_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave, queries at the kv tail."""
    q_pos = torch.arange(sq, dtype=torch.int64) + (skv - sq)
    hi = torch.clamp(q_pos, max=skv - 1) if causal else \
        torch.full((sq,), skv - 1)
    lo = torch.clamp(q_pos - window + 1, min=0) if window else \
        torch.zeros(sq, dtype=torch.int64)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def bound(ops: float, nbytes: float,
          ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    t_ops = ops / ops_per_s * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound(shape, itemsize: int) -> tuple[float, str]:
    """Two products of 2*D operations per visible (query, key) pair and
    head; q, k, v read and o written once."""
    b, hq, hkv, sq, skv, d, causal, window = shape
    ops = 4 * b * hq * d * visible_pairs(sq, skv, causal, window)
    nbytes = itemsize * (2 * b * hq * sq * d + 2 * b * hkv * skv * d)
    return bound(ops, nbytes)


def ssd_bound(shape, itemsize: int) -> tuple[float, str]:
    """Per chunk and head the four products: C.B^T and M @ X over the
    lower triangle's L(L+1)/2 pairs, C @ state and the state update
    B^T @ X; x, b, c read and y written once in ``itemsize``, dt and a in
    float32.  bfloat16 at the tensor cores' rate, float32 at the scalar
    float32 rate (the float32 kernel's FMAs)."""
    b, h, g, s, p, n, chunk = shape
    tri = chunk * (chunk + 1) // 2
    ops = b * h * (s // chunk) * 2 * (tri * n + tri * p + 2 * chunk * n * p)
    nbytes = itemsize * (2 * b * h * s * p + 2 * b * g * s * n) \
        + 4 * (b * h * s + h)
    return bound(ops, nbytes, BF16_OPS_PER_S if itemsize == 2
                 else SCALAR_OPS_PER_S)


def attn_operands(shape, dtype, gen):
    b, hq, hkv, sq, skv, d = shape[:6]
    return tuple(torch.randn(s, generator=gen, device=DEVICE).to(dtype)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d),
                           (b, hkv, skv, d)))


def ssd_operands(shape, dtype, gen):
    """x, b, c standard normal in ``dtype``; dt = softplus(N(0,1) - 1) and
    a = -exp(N(0,1)/2) in float32, as the model passes them."""
    b, h, g, s, p, n = shape[:6]

    def rn(*sz):
        return torch.randn(sz, generator=gen, device=DEVICE)
    x = rn(b, h, s, p).to(dtype)
    dt = torch.nn.functional.softplus(rn(b, h, s) - 1.0)
    a = -torch.exp(rn(h) * 0.5)
    return x, dt, a, rn(b, g, s, n).to(dtype), rn(b, g, s, n).to(dtype)


def sdpa_ms(q, k, v, shape) -> float:
    """One PyTorch call computing the same attention, timed as the
    kernel's yardstick (the port never calls it)."""
    import torch.nn.functional as F
    b, hq, hkv, sq, skv, d, causal, window = shape
    if (sq == skv or not causal) and window is None:
        kw = dict(is_causal=causal)
    else:
        q_pos = torch.arange(sq, device=DEVICE)[:, None] + (skv - sq)
        k_pos = torch.arange(skv, device=DEVICE)[None, :]
        mask = k_pos <= q_pos if causal else torch.ones_like(k_pos > 0)
        if window:
            mask = mask & (k_pos > q_pos - window)
        kw = dict(attn_mask=mask)
    return event_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=hq != hkv, **kw), reps=3)


def ragged_flash(label: str, shape, gen) -> float:
    """One ragged shape of phase 8: the kernel against its plain version
    in bfloat16 (timed beside SDPA and its bound) and in float32.
    Returns the largest difference."""
    from repro_torch.kernels import flash_attention as fa
    causal = shape[6]
    errs, times = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attn_operands(shape, dtype, gen)

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal)
        errs.append(check_close("flash_attention", f"{label} {dtype}",
                                kernel(), fa.plain(q, k, v, causal=causal)))
        times[dtype] = event_ms(kernel, reps=5)
        if dtype == torch.bfloat16:
            plain_ms = event_ms(lambda: fa.plain(q, k, v, causal=causal),
                                reps=1)
            lib_ms = sdpa_ms(q, k, v, shape)
        del q, k, v
    b_ms, by = flash_bound(shape, 2)
    ms = times[torch.bfloat16]
    say(8, f"flash_attention {label} {shape[:6]} causal {causal} (ragged: "
           f"{shape[3]} % 128 = {shape[3] % 128}, {shape[4]} % 128 = "
           f"{shape[4] % 128}) bf16: kernel {ms:.4f} ms, plain "
           f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.4f} "
           f"ms (kernel {ms / lib_ms:.2f}x of it), bound {b_ms:.4f} ms "
           f"({by}, {b_ms / ms:.1%} of it), max |diff| {errs[0]:.3g} "
           f"(limit {TOL[('flash_attention', torch.bfloat16)]}); float32 "
           f"kernel {times[torch.float32]:.4f} ms, max |diff| {errs[1]:.3g} "
           f"(limit {TOL[('flash_attention', torch.float32)]}) [{CARD}]")
    return max(errs)


def phase_kernels() -> dict:
    """Both kernels against their plain versions on the card: the CPU
    tests' matrices in float32 and bfloat16, then the full-width shapes in
    bfloat16, timed.  Returns the record fields of each kernel at its main
    path shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device=DEVICE).manual_seed(8)
    err = {"flash_attention": 0.0, "ssd_scan": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for case in ATTN_CASES:
            causal, window, bq, bk = case[6:]
            q, k, v = attn_operands(case, dtype, gen)
            got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                     block_q=bq, block_k=bk)
            want = fa.plain(q, k, v, causal=causal, window=window)
            err["flash_attention"] = max(err["flash_attention"], check_close(
                "flash_attention", f"{case} {dtype}", got, want))
        for case in SSD_CASES:
            ops = ssd_operands(case, dtype, gen)
            got = ss.ssd_scan(*ops, chunk=case[-1])
            want = ss.plain(*ops, chunk=case[-1])
            err["ssd_scan"] = max(err["ssd_scan"], check_close(
                "ssd_scan", f"{case} {dtype}", got, want))
        say(8, f"{dtype}: kernel == plain within tolerance over "
               f"{len(ATTN_CASES)} attention and {len(SSD_CASES)} SSD cases "
               f"(max |diff| so far: flash {err['flash_attention']:.3g}, "
               f"ssd {err['ssd_scan']:.3g})")
    bf16 = torch.bfloat16
    out = {}
    for i, (label, shape) in enumerate(FLASH_SHAPES):
        causal, window = shape[6:]
        q, k, v = attn_operands(shape, bf16, gen)

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal, window=window)
        e = check_close("flash_attention", label, kernel(),
                        fa.plain(q, k, v, causal=causal, window=window))
        err["flash_attention"] = max(err["flash_attention"], e)
        ms = event_ms(kernel, reps=5)
        plain_ms = event_ms(lambda: fa.plain(q, k, v, causal=causal,
                                             window=window), reps=1)
        lib_ms = sdpa_ms(q, k, v, shape)
        b_ms, by = flash_bound(shape, 2)
        scalar = (f" (the scalar-FMA kernel {SCALAR_FLASH_MS[label]:.3f} "
                  f"ms)" if label in SCALAR_FLASH_MS else "")
        say(8, f"flash_attention {label} {shape[:6]} window {shape[7]} "
               f"bf16, tensor cores: kernel {ms:.3f} ms{scalar}, plain "
               f"{plain_ms:.3f} ms, "
               f"scaled_dot_product_attention {lib_ms:.3f} ms (kernel "
               f"{ms / lib_ms:.2f}x of it), bound {b_ms:.4f} ms ({by}, "
               f"{b_ms / ms:.1%} of it), max |diff| {e:.3g} [{CARD}]")
        if i == 0:
            out["flash_attention"] = dict(ms=ms, plain_ms=plain_ms,
                                          bound_ms=b_ms, bound_by=by,
                                          library_ms=lib_ms)
        del q, k, v
    for label, shape in RAGGED_FLASH_SHAPES:
        err["flash_attention"] = max(err["flash_attention"],
                                     ragged_flash(label, shape, gen))
    lib = ss.load_library()
    for i, (label, shape) in enumerate(SSD_SHAPES):
        ops = ssd_operands(shape, bf16, gen)
        bsz, h, _, _, p, n, chunk = shape
        want = ss.plain(*ops, chunk=chunk)
        k_plan, threads, nbytes = ss.plan(bsz * h, chunk, n, p, bf16)
        per_k = []
        for k in ss.splits(chunk, n, p, bf16):
            # the kernel's own count of its shared memory against plan's
            kb = ss.plan(bsz * h, chunk, n, p, bf16, split=k)[2]
            assert lib.ssd_scan_shared_bytes(chunk, n, p, k, 1) == kb, (
                label, k, kb)
            e = check_close("ssd_scan", f"{label} k={k}",
                            ss.ssd_scan(*ops, chunk=chunk, split=k), want)
            err["ssd_scan"] = max(err["ssd_scan"], e)
            ms_k = event_ms(lambda: ss.ssd_scan(*ops, chunk=chunk, split=k),
                            reps=20)
            per_k.append(f"k={k} ({bsz * h * k} blocks, {kb} B) "
                         f"{ms_k:.4f} ms")
        say(8, f"ssd_scan {label}: every split of P that fits: "
               f"{'; '.join(per_k)} [{CARD}]")
        ms = event_ms(lambda: ss.ssd_scan(*ops, chunk=chunk), reps=20)
        plain_ms = event_ms(lambda: ss.plain(*ops, chunk=chunk), reps=1)
        b_ms, by = ssd_bound(shape, 2)
        scalar = (f" (the scalar-FMA kernel {SCALAR_SSD_MS[label]:.3f} ms)"
                  if label in SCALAR_SSD_MS else "")
        say(8, f"ssd_scan {label} {shape} bf16, tensor cores, plan k="
               f"{k_plan} ({threads} threads, {nbytes} B shared): kernel "
               f"{ms:.4f} ms{scalar}, plain {plain_ms:.3f} ms, no single "
               f"PyTorch call, bound {b_ms:.4f} ms ({by}, {b_ms / ms:.1%} "
               f"of it) [{CARD}]")
        if i == 0:
            out["ssd_scan"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=by, library_ms=None)
        del ops, want
    f32 = torch.float32
    for label, shape in SSD_F32_SHAPES:
        # the scalar float32 kernel at d_state 128: P split over k blocks
        ops = ssd_operands(shape, f32, gen)
        bsz, h, _, _, p, n, chunk = shape
        want = ss.plain(*ops, chunk=chunk)
        k_plan, threads, nbytes = ss.plan(bsz * h, chunk, n, p, f32)
        small = bsz * h * shape[3] <= 8 * 512
        per_k = []
        for k in ss.splits(chunk, n, p, f32) if small else [k_plan]:
            kb = ss.plan(bsz * h, chunk, n, p, f32, split=k)[2]
            assert lib.ssd_scan_shared_bytes(chunk, n, p, k, 0) == kb, (
                label, k, kb)
            e = check_close("ssd_scan", f"{label} float32 k={k}",
                            ss.ssd_scan(*ops, chunk=chunk, split=k), want)
            err["ssd_scan"] = max(err["ssd_scan"], e)
            per_k.append(f"k={k} ({kb} B) max |diff| {e:.3g}")
        ms = event_ms(lambda: ss.ssd_scan(*ops, chunk=chunk), reps=3)
        plain_ms = event_ms(lambda: ss.plain(*ops, chunk=chunk), reps=1)
        b_ms, by = ssd_bound(shape, 4)
        say(8, f"ssd_scan {label} {shape} float32, scalar FMAs, plan k="
               f"{k_plan} ({threads} threads, {nbytes} B shared, "
               f"{bsz * h * k_plan} blocks): kernel {ms:.4f} ms, plain "
               f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({by}, "
               f"{b_ms / ms:.1%} of it); within {TOL[('ssd_scan', f32)]} of "
               f"plain at {'; '.join(per_k)} [{CARD}]")
        del ops, want
    for name in out:
        out[name]["err"] = err[name]
    return out


def timed_forward(cfg, params, tokens, **memory):
    """forward -> unembed, synchronized: (logits, host s, device ms).
    ``memory``: the cross-attention source (``frames`` / ``img_embeds``)."""
    from repro_torch.models import model as M
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    start.record()
    hidden, *_ = M.forward(cfg, params, tokens, **memory)
    logits = M.unembed(cfg, params, hidden)
    stop.record()
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0, start.elapsed_time(stop)


def phase_scoring():
    """The scoring path at full width: forward -> unembed and loss_fn
    through the kernels, their launches counted, held against the plain
    route on the card.  Returns (launches, config, parameters)."""
    from repro_torch.models import model as M

    cfg = model_config()
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen, DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in M.L.tree_leaves(params))
    say(9, f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
           f"{n_params} parameters (ModelConfig.param_count "
           f"{cfg.param_count()}; float32, init_params on the card in "
           f"{time.perf_counter() - t0:.3f} s)")
    tokens = torch.randint(0, cfg.vocab, (SCORE_BATCH, SCORE_SEQ),
                           generator=gen, device=DEVICE)
    launches = score(9, cfg, params, tokens, f32_check=True)
    return launches, cfg, params


def phase_anchor():
    """The JAX package at full width, depth cut to one unit, against the
    port with its kernels on the same numpy weights."""
    from repro_torch.models import convert
    from repro_torch.models import model as M

    with open(MODEL_REFERENCE) as f:
        ref = json.load(f)
    unit = tuple(ref["cut"]["stages"][0][0])
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(ref["arch"]), stages=((unit, 1),),
                              n_layers=ref["cut"]["n_layers"])
    assert cfg.param_count() == ref["cut"]["param_count"]
    t0 = time.perf_counter()
    tree = convert.init_numpy(cfg, ref["seed"])
    mamba = tree["stages"][0]["0"]["mamba"]
    leaves = {"embed": tree["embed"], "unembed": tree["unembed"],
              "stage0.0.mamba.wx": mamba["wx"],
              "stage0.0.mamba.a_log": mamba["a_log"],
              "shared_attn.attn.wq": tree["shared_attn"]["attn"]["wq"]}
    for k, v in leaves.items():
        want = ref["weights"][k]
        assert v.reshape(-1)[:4].tolist() == want["head"], k
        assert math.isclose(float(np.sum(v, dtype=np.float64)), want["sum"],
                            rel_tol=1e-9, abs_tol=1e-9), k
    params = convert.from_reference(cfg, tree, DEVICE)
    del tree, mamba, leaves
    say(10, f"{cfg.param_count()} parameters redrawn from seed "
            f"{ref['seed']} (fingerprint equal to the reference's) and "
            f"moved to the card in {time.perf_counter() - t0:.3f} s")
    tokens = torch.tensor(ref["tokens"], device=DEVICE)
    labels = torch.tensor(ref["labels"], device=DEVICE)
    hidden, *_ = M.forward(cfg, params, tokens)
    logits = M.unembed(cfg, params, hidden).float()
    loss, _ = M.loss_fn(cfg, params, {"tokens": tokens, "labels": labels})
    err, top1 = 0.0, 0
    for e in ref["top_logits"]:
        row = logits[e["row"], e["pos"]]
        want = torch.tensor(e["logits"], device=DEVICE)
        err = max(err, float((row[e["ids"]] - want).abs().max()))
        top1 += int(torch.argmax(row)) == e["ids"][0]
    d_loss = abs(float(loss) - ref["loss"])
    n = len(ref["top_logits"])
    say(10, f"vs the reference (jax {ref['jax_version']}, attn_impl "
            f"{ref['attn_impl']}, {len(unit)} layers at full width, "
            f"{tokens.shape[0]} x {tokens.shape[1]} tokens): top-10 logits "
            f"max |diff| {err:.4f} (limit {ANCHOR_LOGIT_TOL}), top-1 id "
            f"equal at {top1} of {n} positions, loss {float(loss):.6f} vs "
            f"{ref['loss']:.6f} (limit {ANCHOR_LOSS_TOL})")
    assert err <= ANCHOR_LOGIT_TOL and d_loss <= ANCHOR_LOSS_TOL
    assert top1 >= n - 2


def phase_serving(cfg, params, phase: int = 11):
    """ServeEngine at full width: every request completes; the engine's
    prefill (the plain route with a cache) agrees with a cache-free plain
    forward; no kernel launches, as in the reference's routing."""
    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeEngine

    rng = np.random.default_rng(SERVE["seed"])
    lo, hi = SERVE["prompt"]
    n_lo, n_hi = SERVE["new_tokens"]
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab, int(rng.integers(lo, hi + 1))).tolist(),
                max_new_tokens=int(rng.integers(n_lo, n_hi + 1)))
            for i in range(SERVE["n_requests"])]
    eng = ServeEngine(cfg, params, n_slots=SERVE["n_slots"],
                      max_seq=SERVE["max_seq"])
    for r in reqs:
        eng.submit(r)
    reset_counts()
    with host_clock(((M, "prefill"), (M, "decode_step"))) as spent:
        t0 = time.perf_counter()
        ticks = eng.run(max_ticks=10_000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    n_tok = sum(len(r.output) for r in reqs)
    lens = [len(r.prompt) for r in reqs]
    say(phase, f"{cfg.name}: ServeEngine {SERVE['n_slots']} slots, max_seq "
               f"{SERVE['max_seq']}: {len(reqs)} requests (prompts {lens}, "
               f"{sum(lens)} tokens) done in {ticks} ticks, {n_tok} tokens in "
               f"{wall:.3f} s = {n_tok / wall:.2f} tokens/s host wall clock "
               f"incl. prefill; "
               f"{host_split(wall, spent)}; kernel launches {launches} "
               f"[{CARD}]")
    for r in reqs:
        assert r.done and len(r.output) == r.max_new_tokens, r.rid
        assert all(0 <= t < cfg.vocab for t in r.output), r.rid
    assert launches == {"flash_attention": 0, "ssd_scan": 0}
    first = torch.tensor([reqs[0].prompt], device=DEVICE)
    with routes() as pre_routes:
        pre, *_ = M.prefill(cfg, params, first, SERVE["max_seq"])
    plain_cfg = dataclasses.replace(cfg, attn_impl="torch")
    with routes() as plain_routes:
        hidden, *_ = M.forward(plain_cfg, params, first)
    full = M.unembed(plain_cfg, params, hidden[:, -1:])
    flipped, shares = routed_elsewhere(pre_routes, plain_routes,
                                       first.shape, cfg.moe)
    share = float(flipped.float().mean())
    assert share <= ROUTING_SHARE_LIMIT, (cfg.name, shares)
    if bool(flipped[0, -1]):
        # a whole expert apart: the logits say nothing of the cache path
        msg = ("its last token was routed otherwise in some layer, so "
               "its logits are not compared")
    else:
        msg = logits_close("prefill", pre, full)
    routing = (f"{share:.2%} of the prompt's tokens routed otherwise "
               f"(limit {ROUTING_SHARE_LIMIT:.0%}); " if cfg.moe else "")
    say(phase, f"prefill (cached attention, per-token recurrence) vs a "
               f"cache-free plain forward on request 0: {routing}{msg}")
    return n_tok / wall


# ---------------------------------------------------------------------------
# Phase 12: the fabric analysis on the card.
# ---------------------------------------------------------------------------
FABRIC_REFERENCE = os.path.join(ROOT, "tests", "data",
                                "torch_port_fabric_reference.json")
# measure_repair's sizes: phase 6's.
REPAIR_SIZES = (256, 1024)


def cert_dict(cert) -> dict:
    """A certificate as the reference file records it."""
    d = cert.to_dict()
    del d["elapsed_ms"]
    return d


def certified_block(cert) -> dict:
    """``measure_repair``'s ``certified`` block of a certificate."""
    return {"ok": cert.ok,
            "deadlock_free": cert.prop("deadlock_free").ok,
            "route_liveness": cert.prop("route_liveness").ok,
            "witness": [dict(w) for p in cert.failures()
                        for w in p.witness[:1]]}


def certify_ms(spec, device: str, reps: int) -> list[float]:
    """Host ms of ``reps`` uncached certifications of ``spec`` on
    ``device`` (each ends with its results on the host)."""
    from repro_torch.analysis import fabric
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fabric.certify(spec, use_cache=False, device=device)
        out.append((time.perf_counter() - t) * 1e3)
    return out


def phase_analysis(fault_ref, fault_reports) -> None:
    """The fabric analysis on the card: every reference certificate, the
    main path behind ``verify=True``, ``measure_repair`` and the BFS-refill
    cycle witness."""
    from repro_torch import telemetry
    from repro_torch.analysis import fabric
    from repro_torch.core.experiment import Budget, run_experiments
    from repro_torch.core.spec import TopologySpec
    from repro_torch.faults import (measure_repair, sample_faults,
                                    suggest_repair_morph)
    from repro_torch.kernels import noc_step

    t_phase = time.perf_counter()
    with open(FABRIC_REFERENCE) as f:
        ref = json.load(f)
    certs = ref["certificates"]
    t0 = time.perf_counter()
    for e in certs:
        want = e["certificate"]
        got = fabric.certify(TopologySpec.from_dict(want["spec"]),
                             use_cache=False, device="cuda")
        assert cert_dict(got) == want, (e["label"], want["topology"])
    labels = {}
    for e in certs:
        labels[e["label"]] = labels.get(e["label"], 0) + 1
    say(12, f"{len(certs)} certificates certified on the card in "
            f"{time.perf_counter() - t0:.3f} s ({labels}) equal the "
            f"reference's (jax {ref['jax_version']}) as JSON, witnesses "
            f"included; {sum(not e['certificate']['ok'] for e in certs)} "
            f"rejections among them")
    for e in certs:
        want = e["certificate"]
        if e["label"] != "config" or want["n_pes"] != 1024:
            continue
        spec = TopologySpec.from_dict(want["spec"])
        card = certify_ms(spec, "cuda", 3)
        host = certify_ms(spec, "cpu", 1)
        say(12, f"certify {want['topology']} ({want['n_pairs']} pairs, "
                f"{want['n_edges']} edges): "
                f"{' / '.join(f'{t:.1f}' for t in card)} ms on the card, "
                f"{host[0]:.1f} ms on its host with device='cpu' [{CARD}]")

    # The main path behind the pre-flight.
    exps, main_ref = main_path_experiments()
    specs = {e.topology for e in exps}
    fabric.clear_certificate_cache()
    telemetry.drain()
    t0 = time.perf_counter()
    verified = [dataclasses.replace(e, verify=True) for e in exps]
    t_cert = time.perf_counter() - t0
    reports = run_experiments(verified)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = noc_step.launches()[noc_step.STATISTICAL]
    assert launches > 0, "the verified main path never launched the kernel"
    check_main_path(verified, reports, main_ref)
    cached = {s: fabric.certify(s) for s in specs}
    assert fabric.certificate_cache_size() == len(specs)
    assert all(c.ok for c in cached.values())
    t1 = time.perf_counter()
    again = [dataclasses.replace(e, verify=True) for e in exps]
    t_again = time.perf_counter() - t1
    assert len(again) == len(exps)
    assert fabric.certificate_cache_size() == len(specs)
    assert all(fabric.certify(s) is c for s, c in cached.items())
    say(12, f"figs15_17 grid with Experiment(verify=True): {len(exps)} "
            f"points, {len(specs)} fabrics certified on the card in "
            f"{t_cert:.3f} s = {t_cert / wall:.1%} of the {wall:.3f} s host "
            f"wall clock; {launches} noc_step launches; every report equals "
            f"the reference's field for field; a second verify=True "
            f"construction of all points took {t_again * 1e3:.3f} ms "
            f"(cache hits: still {len(specs)} certificates, the same "
            f"objects) [{CARD}]")

    # measure_repair on the fault recipe's repair scenario.
    r = fault_ref["recipes"]["fault_tolerance"]
    depth = fault_ref["recipes"]["src_queue_depth"]
    rc, rs = r["repair_count"], r["seeds"][0]
    want_certs = [e["certificate"] for e in certs
                  if e["label"] == "fault_recipe_repair"]
    telemetry.drain()
    t0 = time.perf_counter()
    outs = {}
    for n in REPAIR_SIZES:
        budget = Budget(cycles=r["cycles"][str(n)], warmup=0)
        for fam in ("ring_mesh", "flat_mesh"):
            spec = _spec(fam, n, depth)
            flt = sample_faults(spec.build(), n_dead_links=rc, seed=rs)
            outs[(fam, n)] = (spec, flt, measure_repair(
                spec, flt, inj_rate=r["inj_rate"][str(n)], budget=budget,
                seed=r["seed"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = noc_step.launches()
    say(12, f"measure_repair at {REPAIR_SIZES} PEs: launches by mode "
            f"{launches}, {wall:.3f} s host wall clock [{CARD}]")
    assert launches[noc_step.FAULTS] > 0, "no fault-mode launch"
    for (fam, n), (spec, flt, out) in outs.items():
        legs = {"healthy": fault_reports[(fam, n, "healthy", 0, 0)],
                "faulted": fault_reports[(fam, n, "faulted", rc, rs)],
                "repaired": fault_reports[(fam, n, "repaired", rc, rs)]}
        healthy, faulted, repaired = legs.values()
        want = {
            "scenario": flt.to_dict(),
            "delivered_fraction": {k: round(v.delivered_fraction, 4)
                                   for k, v in legs.items()},
            "reachability": {k: round(v.reachability, 4)
                             for k, v in legs.items()},
            "avg_latency": {k: round(v.sim.avg_latency, 2)
                            for k, v in legs.items()},
            "latency_inflation": {
                "faulted": round(faulted.latency_inflation(healthy), 4),
                "repaired": round(repaired.latency_inflation(healthy), 4)},
            "repair_gain": round(repaired.delivered_fraction
                                 - faulted.delivered_fraction, 4)}
        got = {k: v for k, v in out.items() if k != "certified"}
        assert got == want, (fam, n, got, want)
        repaired_spec = suggest_repair_morph(spec, flt).to_dict()
        cert = next(c for c in want_certs if c["spec"] == repaired_spec)
        block = certified_block(fabric.FabricCertificate.from_dict(cert))
        assert out["certified"] == block, (fam, n, out["certified"])
        say(12, f"measure_repair {fam}_{n} ({rc} dead links, seed {rs}): "
                f"delivered fraction {out['delivered_fraction']}, repair "
                f"gain {out['repair_gain']}, certified "
                f"{out['certified']['ok']}"
                + (f" (witness {out['certified']['witness'][0]['kind']})"
                   if out['certified']['witness'] else "")
                + " == phase 6's legs and the reference certificate")

    # The BFS-refill cycle, caught on the card.
    b = ref["recipe"]["bfs_refill_cycle"]
    want = next(e["certificate"] for e in certs
                if e["label"] == "bfs_refill_cycle")
    base = TopologySpec(b["family"], b["n_pes"])
    spec = dataclasses.replace(base, faults=sample_faults(
        base.build(), n_dead_links=b["n_dead_links"], seed=b["seed"]))
    assert spec.to_dict() == want["spec"]
    cert = fabric.certify(spec, use_cache=False, device="cuda")
    witness = cert.prop("deadlock_free").witness[0]["queues"]
    ref_witness = next(p for p in want["properties"]
                       if p["name"] == "deadlock_free")["witness"][0]
    assert not cert.ok and witness == ref_witness["queues"]
    say(12, f"BFS-refill cycle: {spec.name} with {b['n_dead_links']} dead "
            f"links (sample_faults seed {b['seed']}) REJECTED on the card; "
            f"queue-cycle witness {witness} == the reference's")
    say(12, f"phase 12 took {time.perf_counter() - t_phase:.3f} s host "
            f"wall clock [{CARD}]")


# ---------------------------------------------------------------------------
# Phases 13-15: the decoder-only model zoo at full width.
# ---------------------------------------------------------------------------
ZOO_REFERENCE = os.path.join(ROOT, "tests", "data",
                             "torch_port_zoo_reference.json")
# (architecture, layers run (None: all of them), (batch, seq), whether the
# float32-compute check runs).  Every model runs at its published widths.
# The last four are cut in depth (and llama4-scout and command-r-plus in
# tokens) for device memory: their float32 master parameters at full
# depth (qwen2.5-14b 59 GB, phi3.5-moe 167 GB, llama4-scout 431 GB,
# command-r-plus 428 GB) leave too little of the card's 80 GB, or do not
# fit at all, beside the bfloat16 logits (2.5 GB at vocab 152 064 over
# 2 x 4096 tokens), the plain route's copy of them and its loss chunks.
ZOO = [
    ("qwen2-7b", None, (2, 4096), True),
    ("h2o-danube-1.8b", None, (1, 8192), True),
    ("mamba2-1.3b", None, (2, 4096), True),
    ("qwen2.5-14b", 12, (2, 4096), False),
    ("phi3.5-moe-42b-a6.6b", 4, (2, 4096), True),
    ("llama4-scout-17b-a16e", 2, (2, 2048), True),
    ("command-r-plus-104b", 2, (1, 4096), False),
]
ZOO_SEED = 13
# Phase 15 serves these two of phase 13's models, with phase 11's recipe.
SERVE_ZOO = ("qwen2-7b", "phi3.5-moe-42b-a6.6b")
# A MoE layer routes a token elsewhere wherever its input differs by an
# ulp between two near-equal gates, and that token's output then differs
# by a whole expert's; the shifted running counts of its experts can also
# move which later token is the last to fit their capacity.  So on a MoE
# model the logits are held only at the positions routed alike, experts
# and capacity, in every layer (each run's experts are recorded at its
# top-k), to the limits of a dense model; the loss within its limit plus
# FLIPPED_CE nats times the share of tokens routed otherwise
# (phi3.5-moe's full-width layer on a CPU against the JAX package: 7 of
# 512 tokens routed elsewhere moved the mean by 0.0061, 0.66 nats each,
# and tokens shifted past capacity by 0.0041 more); the auxiliary loss
# within 0.02 (a flipped first choice moves it by n_experts / T times a
# gate mean).  Kernels vs the plain route on an H100 (80GB HBM3, 700 W):
# 20 % rms difference over all of phi3.5-moe's logits (four layers,
# 8 192 tokens) against 3-4.5 % on the dense models; 0.6 % of
# the tokens were routed elsewhere in the first layer, whose input
# differs only by the attention kernel's rounding, and 8.8 % in the
# fourth, as the differences compound.  The first layer's share is held
# to ROUTING_SHARE_LIMIT.  With float32 compute a flip needs two gates
# within float32's summation-order differences: at most 1 % of the
# tokens (measured 1 of 8 192).
AUX_TOL, FLIPPED_CE, F32_FLIP_SHARE = 0.02, 1.5, 0.01
# Against the JAX anchor in bfloat16 (one layer): the share of tokens
# routed otherwise may reach 5 % (CPU: 1.0-1.4 % routed elsewhere), and
# the top-10 logits of such a position stay within 1.0 (one expert's
# contribution through one layer).
ROUTING_SHARE_LIMIT, FLIPPED_LOGIT_TOL = 0.05, 1.0


@contextlib.contextmanager
def routes():
    """The experts every MoE layer routes to while the block runs: one
    (T, k) tensor per ``top_k`` call, in layer order."""
    from repro_torch.models import layers as L
    out, top_k = [], L.top_k

    def recording(gates, k):
        vals, idx = top_k(gates, k)
        out.append(idx)
        return vals, idx
    L.top_k = recording
    try:
        yield out
    finally:
        L.top_k = top_k


def dispatch(idx, moe):
    """A layer's recorded (T, k) experts, sorted per token, and which of
    the choices keep a slot: the capacity ``moe_block`` computes, filled
    in token-major order."""
    t, k = idx.shape
    cap = max(math.ceil(t * k * moe.capacity_factor / moe.n_experts), 4)
    flat = idx.reshape(-1)
    count = torch.cumsum(torch.nn.functional.one_hot(flat, moe.n_experts),
                         dim=0)
    kept = (torch.gather(count, 1, flat[:, None])[:, 0] <= cap).reshape(t, k)
    ids, order = idx.sort(-1)
    return ids, kept.gather(-1, order)


def routed_elsewhere(got, want, shape, moe=None):
    """(mask over ``shape``'s tokens handled otherwise in any layer, the
    share of such tokens per layer).  A token is handled otherwise where
    its set of experts differs, or where a choice of it keeps its slot in
    one run and overflows the capacity in the other: a token routed
    elsewhere shifts the running counts of its experts, and with them
    which later token is the last to fit."""
    if not want:
        return torch.zeros(shape, dtype=torch.bool), []
    assert len(got) == len(want)
    flips = []
    for a, b in zip(got, want):
        (ia, ka), (ib, kb) = dispatch(a.cpu(), moe), dispatch(b.cpu(), moe)
        flips.append((ia != ib).any(-1) | (ka != kb).any(-1))
    flips = torch.stack(flips)
    return (flips.any(0).reshape(shape),
            [round(float(f), 4) for f in flips.float().mean(-1)])


def zoo_config(arch: str, depth):
    """The architecture at its published widths, its one stage cut to
    ``depth`` repeats (all of them if None)."""
    from repro_torch import configs
    cfg = configs.get(arch)
    if depth is None:
        return cfg
    (unit, _reps), = cfg.stages
    return dataclasses.replace(cfg, stages=((unit, depth),),
                               n_layers=len(unit) * depth)


def rms_distance(x, ref) -> float:
    """rms(x - ref) / rms(ref) over float32 logits, one batch row at a
    time (``x`` may sit on the host)."""
    num = den = 0.0
    for i in range(ref.shape[0]):
        r = ref[i].float()
        num += float((x[i].to(r.device).float() - r).square().sum())
        den += float(r.square().sum())
    return math.sqrt(num / den)


def score(phase: int, cfg, params, tokens, f32_check: bool,
          memory=None, against_float32: bool = False) -> dict:
    """forward -> unembed and loss_fn through the kernels, their launches
    counted, timed and held to the plain route on the card (and with
    float32 compute if ``f32_check``).  ``memory``: the batch's
    cross-attention source, ``{"frames": ...}`` or ``{"img_embeds":
    ...}``, in bfloat16.  With ``against_float32`` (and ``f32_check``)
    the bfloat16 logits of both routes are held to the float32-compute
    plain route instead of to each other (``FLOAT32_RATIO``).  Returns
    the launches of forward + loss_fn."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import model as M

    name, shape = cfg.name, tuple(tokens.shape)
    memory = memory or {}
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1),
             **memory}
    want = kernel_counts(cfg)
    reset_counts()
    with routes() as kernel_routes:
        logits, host_s, dev_ms = timed_forward(cfg, params, tokens,
                                               **memory)
    per_forward = launch_counts()
    loss, parts = M.loss_fn(cfg, params, batch)
    launches = launch_counts()
    assert per_forward == want, (name, per_forward, want)
    assert launches == {k: 2 * v for k, v in want.items()}, (name, launches)
    assert logits.shape == (*shape, cfg.vocab)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(loss))
    runs = [timed_forward(cfg, params, tokens, **memory)[1:]
            for _ in range(2)]
    with device_clock(((fa, "flash_attention"),
                       (ss, "ssd_scan"))) as spent:
        _, _, split_ms = timed_forward(cfg, params, tokens, **memory)
    kernel_ms = sum(spent.values())
    n_tok = shape[0] * shape[1]
    say(phase, f"{name}: launches per forward {per_forward}, over forward "
               f"+ loss_fn {launches}; loss {float(loss):.6f} (ln vocab "
               f"{math.log(cfg.vocab):.6f}), aux {float(parts['aux']):.6f}; "
               f"first call {host_s:.3f} s host / {dev_ms:.3f} ms device; "
               f"warm {runs[0][0]:.3f} / {runs[1][0]:.3f} s host, "
               f"{runs[0][1]:.3f} / {runs[1][1]:.3f} ms device = "
               f"{n_tok / runs[1][1] * 1e3:.0f} tokens/s; a third "
               f"{split_ms:.3f} ms = flash_attention "
               f"{spent['flash_attention']:.3f} ms + ssd_scan "
               f"{spent['ssd_scan']:.3f} ms ({kernel_ms / split_ms:.1%}) + "
               f"rest {split_ms - kernel_ms:.3f} ms (CUDA events around "
               f"each wrapper call) [{CARD}]")

    plain_cfg = dataclasses.replace(cfg, attn_impl="torch")
    with routes() as plain_routes:
        plain_logits, plain_s, plain_dev = timed_forward(plain_cfg, params,
                                                         tokens, **memory)
    plain_loss, plain_parts = M.loss_fn(plain_cfg, params, batch)
    flipped, shares = routed_elsewhere(kernel_routes, plain_routes, shape,
                                       cfg.moe)
    share = float(flipped.float().mean())
    d_loss = abs(float(loss) - float(plain_loss))
    loss_tol = SCORE_LOSS_TOL + FLIPPED_CE * share
    d_aux = abs(float(parts["aux"]) - float(plain_parts["aux"]))
    if cfg.moe:
        alike = ~flipped.to(logits.device)
        logits, plain_logits = logits[alike], plain_logits[alike]
    if against_float32:
        rel = rms_distance(logits, plain_logits)
        msg = (f"rms difference {rel:.2e} of the rms (held below against "
               f"the float32 model, not to phase 9's {SCORE_RMS_TOL})")
        kept = {"kernels": logits.cpu(), "plain": plain_logits.cpu()}
    else:
        msg = logits_close(f"{name} scoring", logits, plain_logits)
    routing = (f"routed otherwise (other experts or past capacity) in "
               f"some layer: {share:.2%} of the tokens "
               f"(per layer {shares}); at the others " if cfg.moe else "")
    say(phase, f"{name}: kernels vs plain (plain route {plain_s:.3f} s "
               f"host, {plain_dev:.3f} ms device), bfloat16: {routing}{msg}"
               + ("" if against_float32 else f" (limit {SCORE_RMS_TOL})")
               + f"; |d loss| {d_loss:.2e} (limit "
               f"{loss_tol:.4f}); |d aux| {d_aux:.2e} (limit {AUX_TOL}) "
               f"[{CARD}]")
    assert d_loss <= loss_tol and d_aux <= AUX_TOL
    assert not shares or shares[0] <= ROUTING_SHARE_LIMIT, (name, shares)
    del logits, plain_logits
    free_card()
    if f32_check:
        saved = M.COMPUTE_DTYPE
        M.COMPUTE_DTYPE = torch.float32
        memory = {k: v.float() for k, v in memory.items()}
        batch.update(memory)
        try:
            reset_counts()
            with routes() as kernel_routes:
                got, _, f32_ms = timed_forward(cfg, params, tokens, **memory)
            assert launch_counts() == want, (name, launch_counts())
            with routes() as plain_routes:
                want_l, _, f32_plain_ms = timed_forward(plain_cfg, params,
                                                        tokens, **memory)
            flipped, _ = routed_elsewhere(kernel_routes, plain_routes,
                                          shape, cfg.moe)
            share = float(flipped.float().mean())
            if cfg.moe:
                alike = ~flipped.to(got.device)
                got, want_l = got[alike], want_l[alike]
            msg = logits_close(f"{name} scoring float32", got, want_l)
            del got
            if against_float32:
                dist = {k: rms_distance(v, want_l) for k, v in kept.items()}
                say(phase, f"{name}: bfloat16 logits against the float32-"
                           f"compute plain route: rms distance of the "
                           f"kernels' route {dist['kernels']:.4e}, of the "
                           f"plain route {dist['plain']:.4e} (ratio "
                           f"{dist['kernels'] / dist['plain']:.4f}, limit "
                           f"{FLOAT32_RATIO})")
                assert dist["kernels"] <= FLOAT32_RATIO * dist["plain"], dist
                del kept
            del want_l
            free_card()
            d_loss = abs(float(M.loss_fn(cfg, params, batch)[0])
                         - float(M.loss_fn(plain_cfg, params, batch)[0]))
        finally:
            M.COMPUTE_DTYPE = saved
        routing = (f"routed otherwise: {share:.2%} of the tokens (limit "
                   f"{F32_FLIP_SHARE:.0%}); at the others "
                   if cfg.moe else "")
        say(phase, f"{name}: kernels vs plain, float32 compute "
                   f"({f32_ms:.3f} / {f32_plain_ms:.3f} ms device): "
                   f"{routing}{msg} (limit {SCORE_F32_TOL} + "
                   f"{SCORE_F32_TOL} * |plain|); |d loss| {d_loss:.2e} "
                   f"(limit {SCORE_F32_TOL})")
        assert share <= F32_FLIP_SHARE
        assert d_loss <= SCORE_F32_TOL + FLIPPED_CE * share
    return launches


def score_zoo_model(arch: str, depth, shape, f32_check: bool) -> dict:
    """One model of phase 13, drawn on the card from ``ZOO_SEED`` and
    scored; returns the launches of forward + loss_fn."""
    from repro_torch.models import model as M

    cfg = zoo_config(arch, depth)
    full = zoo_config(arch, None)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        ZOO_SEED), DEVICE)
    torch.cuda.synchronize()
    cut = ("all layers" if depth is None else
           f"cut from {full.n_layers} layers for device memory: "
           f"{4 * full.param_count() / 1e9:.1f} GB of float32 parameters "
           f"at full depth, {4 * cfg.param_count() / 1e9:.1f} GB here")
    say(13, f"{arch}: d_model {cfg.d_model}, {cfg.n_layers} layers "
            f"({cut}), {cfg.param_count()} parameters from init_params on "
            f"the card in {time.perf_counter() - t0:.3f} s; "
            f"{shape[0]} x {shape[1]} tokens"
            + ("" if depth is None or shape == (2, 4096) else
               " (tokens cut for the logits' memory)"))
    gen = torch.Generator(device=DEVICE).manual_seed(ZOO_SEED + 1)
    tokens = torch.randint(0, cfg.vocab, shape, generator=gen, device=DEVICE)
    launches = score(13, cfg, params, tokens, f32_check)
    del params
    free_card()
    return launches


def phase_zoo_scoring() -> dict:
    """Phase 13: the seven decoder-only architectures scored at full width.
    Returns the kernels' launches summed over the models."""
    t0 = time.perf_counter()
    total = {"flash_attention": 0, "ssd_scan": 0}
    for arch, depth, shape, f32_check in ZOO:
        for k, v in score_zoo_model(arch, depth, shape, f32_check).items():
            total[k] += v
    say(13, f"{len(ZOO)} architectures scored in "
            f"{time.perf_counter() - t0:.1f} s host wall clock; launches "
            f"{total} [{CARD}]")
    return total


def leaf(tree, key: str):
    """A leaf of a parameter tree by the anchor file's dotted name."""
    if key in ("embed", "unembed"):
        return tree[key]
    node = tree["stages"][0]
    for part in key.split(".")[1:]:
        node = node[part]
    return node


def zoo_cut(arch: str, e: dict):
    """The architecture at full width cut as the zoo anchor file says."""
    (_unit, reps), = e["cut"]["stages"]
    return zoo_config(arch, reps)


def draw_anchor_trees(path: str, cut) -> dict:
    """{arch: (numpy weights, seconds)} of an anchor file's models, drawn
    by ``convert.init_numpy`` from its seed on the host.  ``main`` runs it
    in a thread beside the card's work of the phase before: numpy's draws
    release the interpreter lock."""
    from repro_torch.models import convert
    with open(path) as f:
        ref = json.load(f)
    out = {}
    for arch, e in ref["models"].items():
        t0 = time.perf_counter()
        out[arch] = (convert.init_numpy(cut(arch, e), ref["seed"]),
                     time.perf_counter() - t0)
    return out


def phase_zoo_anchor(trees: dict) -> dict:
    """Phase 14: one layer of four architectures at full width against the
    JAX package on the same numpy weights (``trees``, from
    ``draw_anchor_trees``).  Returns the kernels' launches."""
    from repro_torch.models import convert
    from repro_torch.models import model as M

    with open(ZOO_REFERENCE) as f:
        ref = json.load(f)
    total = {"flash_attention": 0, "ssd_scan": 0}
    for arch, e in ref["models"].items():
        cfg = zoo_cut(arch, e)
        assert cfg.param_count() == e["cut"]["param_count"], arch
        t0 = time.perf_counter()
        tree, drawn = trees.pop(arch)
        for key, want in e["weights"].items():
            v = leaf(tree, key)
            assert v.reshape(-1)[:4].tolist() == want["head"], (arch, key)
            assert math.isclose(float(np.sum(v, dtype=np.float64)),
                                want["sum"], rel_tol=1e-9,
                                abs_tol=1e-9), (arch, key)
        params = convert.from_reference(cfg, tree, DEVICE)
        del tree
        say(14, f"{arch}: {cfg.param_count()} parameters ({cfg.n_layers} "
                f"layer at full width) redrawn from seed {ref['seed']} "
                f"(in {drawn:.3f} s on the host during phase 13; fingerprint "
                f"of {len(e['weights'])} leaves equal to the reference's) "
                f"and moved to the card in {time.perf_counter() - t0:.3f} s")
        tokens = torch.tensor(e["tokens"], device=DEVICE)
        labels = torch.tensor(e["labels"], device=DEVICE)
        reset_counts()
        with routes() as routed:
            hidden, *_ = M.forward(cfg, params, tokens)
        logits = M.unembed(cfg, params, hidden).float()
        loss, parts = M.loss_fn(cfg, params, {"tokens": tokens,
                                              "labels": labels})
        for k, v in launch_counts().items():
            total[k] += v
        assert launch_counts() == {
            k: 2 * v for k, v in kernel_counts(cfg).items()}, arch
        want = [torch.tensor(e["experts"]).reshape(-1, cfg.moe.top_k)
                ] if "experts" in e else []
        flipped, _ = routed_elsewhere(routed, want, tokens.shape, cfg.moe)
        share = float(flipped.float().mean())
        if cfg.moe:
            say(14, f"{arch}: routing (experts or capacity) differs from "
                    f"the reference's at "
                    f"{int(flipped.sum())} of {flipped.numel()} tokens "
                    f"({share:.2%}; limit {ROUTING_SHARE_LIMIT:.0%})")
            assert share <= ROUTING_SHARE_LIMIT, (arch, share)
        err, err_flipped, top1 = 0.0, 0.0, 0
        for t in e["top_logits"]:
            row = logits[t["row"], t["pos"]]
            d = float((row[t["ids"]] - torch.tensor(
                t["logits"], device=DEVICE)).abs().max())
            if flipped[t["row"], t["pos"]]:
                err_flipped = max(err_flipped, d)
            else:
                err = max(err, d)
                top1 += int(torch.argmax(row)) == t["ids"][0]
        n = len(e["top_logits"])
        n_alike = n - int(sum(flipped[t["row"], t["pos"]]
                              for t in e["top_logits"]))
        d_loss = abs(float(loss) - e["loss"])
        loss_tol = ANCHOR_LOSS_TOL + FLIPPED_CE * share
        d_aux = abs(float(parts["aux"]) - e["aux"])
        say(14, f"{arch} vs the reference (jax {ref['jax_version']}, "
                f"attn_impl {ref['attn_impl']}, {tokens.shape[0]} x "
                f"{tokens.shape[1]} tokens): top-10 logits max |diff| "
                f"{err:.4f} at {n_alike} positions routed alike (limit "
                f"{ANCHOR_LOGIT_TOL})"
                + (f", {err_flipped:.4f} at {n - n_alike} routed elsewhere "
                   f"(limit {FLIPPED_LOGIT_TOL})" if n_alike < n else "")
                + f", top-1 id equal at {top1} of {n_alike}; loss "
                f"{float(loss):.6f} vs {e['loss']:.6f} (limit "
                f"{loss_tol:.4f}); aux {float(parts['aux']):.6f} vs "
                f"{e['aux']:.6f} (limit {AUX_TOL}) [{CARD}]")
        assert err <= ANCHOR_LOGIT_TOL and err_flipped <= FLIPPED_LOGIT_TOL
        assert d_loss <= loss_tol and d_aux <= AUX_TOL
        assert top1 >= n_alike - 2
        del params, logits, hidden
        free_card()
    return total


def phase_zoo_serving() -> None:
    """Phase 15: ServeEngine on two of phase 13's models, redrawn from the
    same seed, with phase 11's recipe."""
    from repro_torch.models import model as M
    depths = {arch: depth for arch, depth, _, _ in ZOO}
    for arch in SERVE_ZOO:
        cfg = zoo_config(arch, depths[arch])
        params = M.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(ZOO_SEED), DEVICE)
        phase_serving(cfg, params, phase=15)
        del params
        free_card()


# ---------------------------------------------------------------------------
# Phases 16-19: cross-attention and the encoders; the training path.
# ---------------------------------------------------------------------------
CROSS_REFERENCE = os.path.join(ROOT, "tests", "data",
                               "torch_port_cross_reference.json")
CROSS_SEED = 17
# (architecture, batch, tokens), every layer at the published widths:
# whisper-small's 16 x 448 decoder tokens over 16 x 1 500 frames, the
# vision model's 2 x 4 096 tokens over 2 x 1 600 image tokens.  The frames
# and image embeddings are seeded normals, stubs in the reference too.
CROSS = [("whisper-small", 16, 448), ("llama-3.2-vision-11b", 2, 4096)]
# Phase 18: 2 requests per model, prompts of these lengths, 16 new tokens.
CROSS_PROMPT = {"whisper-small": 64, "llama-3.2-vision-11b": 256}
CROSS_NEW_TOKENS = 16
# Phase 17, the gradient against the JAX reference's (whisper-small, one
# encoder and one decoder layer, bfloat16 compute in both, the port's
# plain route): each recorded norm within this relative difference.  The
# port's plain route on a CPU comes within 4.6e-6 on the global norm and
# 1.1e-3 on the leaves (the encoder's final norm scale); the limit is nine
# times that, for cuBLAS's other summation orders in bfloat16.
GRAD_NORM_TOL = 0.01
# Phase 19: mamba2-1.3b, the default --arch of the reference's
# launch/train.py, at full width with its depth cut to 6 of 48 layers
# (each checkpoint ~4.3 GB instead of 17.4 GB: the four saves and the
# restore were two thirds of the phase, and the whole run has to leave
# room for phases 20 and 21 inside its 600 s, phase 21(b) holding a
# full-depth training step); AdamW as launch/train.py
# builds it but with 2 warm-up steps (its 100 would keep the learning
# rate too small to move the loss in 6 steps); one injected failure.
TRAIN = dict(arch="mamba2-1.3b", depth=6, batch=4, seq=2048, steps=6,
             checkpoint_every=2, fail_at=3, lr=1e-3, warmup_steps=2,
             seed=19)
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
WHISPER_TRAIN = dict(batch=4, seq=448, steps=2)


def memory_input(cfg, batch: int, gen) -> dict:
    """The batch's cross-attention source, seeded normals in bfloat16:
    ``{"frames": ...}`` or ``{"img_embeds": ...}``."""
    key = "frames" if cfg.encoder_layers else "img_embeds"
    rows = cfg.encoder_seq or cfg.n_img_tokens
    return {key: torch.randn((batch, rows, cfg.d_model), generator=gen,
                             device=DEVICE).to(torch.bfloat16)}


def named(tree, key: str):
    """A leaf of a reference-layout tree by its dotted path (list indices
    as numbers), as the anchor files name them."""
    node = tree
    for part in key.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def check_fingerprint(label: str, v, want: dict) -> None:
    assert np.asarray(v).reshape(-1)[:4].tolist() == want["head"], label
    assert math.isclose(float(np.sum(v, dtype=np.float64)), want["sum"],
                        rel_tol=1e-9, abs_tol=1e-9), label


def cross_params(cfg):
    """Phase 16's weights: whisper-small through ``convert.init_numpy``
    on the host; the vision model from ``init_params`` on the card, since
    its 10.1 billion numpy draws would take minutes of host time (the
    rate is measured on whisper's draws and printed)."""
    from repro_torch.models import convert
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    if cfg.encoder_layers:
        tree = convert.init_numpy(cfg, CROSS_SEED)
        drawn = time.perf_counter() - t0
        params = convert.from_reference(cfg, tree, DEVICE)
        torch.cuda.synchronize()
        n = sum(v.size for v in M.L.tree_leaves(tree))
        rate = n / drawn
        vision = zoo_config("llama-3.2-vision-11b", None).param_count()
        say(16, f"{cfg.name}: {n} parameters drawn by convert.init_numpy "
                f"from seed {CROSS_SEED} in {drawn:.3f} s ({rate / 1e6:.1f} "
                f"M/s on this host; the vision model's {vision} would take "
                f"{vision / rate:.0f} s) and moved to the card in "
                f"{time.perf_counter() - t0 - drawn:.3f} s")
        return params
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        CROSS_SEED), DEVICE)
    torch.cuda.synchronize()
    say(16, f"{cfg.name}: {cfg.param_count()} parameters "
            f"({4 * cfg.param_count() / 1e9:.1f} GB of float32 master "
            f"parameters, all {cfg.n_layers} layers) from init_params on "
            f"the card in {time.perf_counter() - t0:.3f} s")
    return params


def phase_cross_scoring() -> tuple[dict, dict]:
    """Phase 16: whisper-small and llama-3.2-vision-11b scored at full
    width through the kernels, held to the plain route.  Returns (the
    launches of forward + loss_fn summed, {arch: (config, params)})."""
    t0 = time.perf_counter()
    total = {"flash_attention": 0, "ssd_scan": 0}
    models = {}
    for arch, batch, seq in CROSS:
        cfg = zoo_config(arch, None)
        params = cross_params(cfg)
        gen = torch.Generator(device=DEVICE).manual_seed(CROSS_SEED + 1)
        tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                               device=DEVICE)
        memory = memory_input(cfg, batch, gen)
        (key, mem), = memory.items()
        say(16, f"{arch}: {cfg.n_layers} decoder layers"
                + (f" + {cfg.encoder_layers} encoder layers" if
                   cfg.encoder_layers else "")
                + f", d_model {cfg.d_model}; {batch} x {seq} tokens over "
                f"{key} {tuple(mem.shape)}; flash launches per forward "
                f"{kernel_counts(cfg)['flash_attention']}")
        for k, v in score(16, cfg, params, tokens, f32_check=True,
                          memory=memory, against_float32=True).items():
            total[k] += v
        models[arch] = (cfg, params)
        free_card()
    say(16, f"{len(CROSS)} architectures scored in "
            f"{time.perf_counter() - t0:.1f} s host wall clock; launches "
            f"{total} [{CARD}]")
    return total, models


def cross_cut(arch: str, e: dict):
    """The architecture at full width cut as the anchor file says."""
    (unit, reps), = e["cut"]["stages"]
    return dataclasses.replace(zoo_config(arch, None),
                               stages=((tuple(unit), reps),),
                               n_layers=e["cut"]["n_layers"],
                               encoder_layers=e["cut"]["encoder_layers"])


def grad_norms(cfg, params, batch) -> dict:
    """The gradient of loss_fn through the plain route (the kernels have
    no backward), as the anchor file records it: its global norm and the
    norm of every xattn and encoder leaf."""
    from repro_torch.models import convert
    from repro_torch.models import model as M
    plain_cfg = dataclasses.replace(cfg, attn_impl="torch")
    live = M.L.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = M.loss_fn(plain_cfg, live, batch)
    grads = torch.autograd.grad(loss, M.L.tree_leaves(live))
    it = iter(g.float() for g in grads)
    tree = convert.to_reference(cfg, M.L.tree_map(lambda _: next(it),
                                                  params))
    out = {"global": float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                          for g in grads)))}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}")
        elif prefix.startswith(".encoder") or ".xattn." in prefix:
            out[prefix[1:]] = float(np.linalg.norm(
                node.reshape(-1).astype(np.float64)))
    walk(tree, "")
    return out, float(loss.detach())


def phase_cross_anchor(trees: dict) -> dict:
    """Phase 17: whisper-small (one encoder and one decoder layer) and one
    vision unit at full width against the JAX package on the same numpy
    weights (``trees``, from ``draw_anchor_trees``) and memory; whisper's
    gradient too.  Returns the kernels' launches."""
    from repro_torch.models import convert
    from repro_torch.models import model as M

    with open(CROSS_REFERENCE) as f:
        ref = json.load(f)
    total = {"flash_attention": 0, "ssd_scan": 0}
    for arch, e in ref["models"].items():
        cfg = cross_cut(arch, e)
        assert cfg.param_count() == e["cut"]["param_count"], arch
        t0 = time.perf_counter()
        tree, drawn = trees.pop(arch)
        for key, want in e["weights"].items():
            check_fingerprint(f"{arch} {key}", named(tree, key), want)
        m = e["memory"]
        mem = np.random.default_rng(ref["seed"] + 2).standard_normal(
            tuple(m["shape"]), dtype=np.float32)
        check_fingerprint(f"{arch} {m['key']}", mem, m)
        params = convert.from_reference(cfg, tree, DEVICE)
        del tree
        say(17, f"{arch}: {cfg.param_count()} parameters ({e['cut']['note']}"
                f") and its {m['key']} {tuple(m['shape'])} redrawn from seed "
                f"{ref['seed']} (the weights in {drawn:.3f} s on the host "
                f"during phase 16; fingerprint of {len(e['weights'])} leaves "
                f"equal to the reference's) and moved to the card in "
                f"{time.perf_counter() - t0:.3f} s")
        memory = {m["key"]: torch.from_numpy(mem).to(DEVICE).to(
            torch.bfloat16)}
        batch = {"tokens": torch.tensor(e["tokens"], device=DEVICE),
                 "labels": torch.tensor(e["labels"], device=DEVICE),
                 **memory}
        reset_counts()
        hidden, *_ = M.forward(cfg, params, batch["tokens"], **memory)
        logits = M.unembed(cfg, params, hidden).float()
        loss, _ = M.loss_fn(cfg, params, batch)
        for k, v in launch_counts().items():
            total[k] += v
        assert launch_counts() == {
            k: 2 * v for k, v in kernel_counts(cfg).items()}, arch
        err, top1 = 0.0, 0
        for t in e["top_logits"]:
            row = logits[t["row"], t["pos"]]
            err = max(err, float((row[t["ids"]] - torch.tensor(
                t["logits"], device=DEVICE)).abs().max()))
            top1 += int(torch.argmax(row)) == t["ids"][0]
        n = len(e["top_logits"])
        d_loss = abs(float(loss) - e["loss"])
        say(17, f"{arch} vs the reference (jax {ref['jax_version']}, "
                f"attn_impl {ref['attn_impl']}, {tuple(batch['tokens'].shape)}"
                f" tokens, {launch_counts()['flash_attention']} flash "
                f"launches over forward + loss_fn): top-10 logits max |diff| "
                f"{err:.4f} (limit {ANCHOR_LOGIT_TOL}), top-1 id equal at "
                f"{top1} of {n}; loss {float(loss):.6f} vs {e['loss']:.6f} "
                f"(limit {ANCHOR_LOSS_TOL}) [{CARD}]")
        assert err <= ANCHOR_LOGIT_TOL and d_loss <= ANCHOR_LOSS_TOL
        assert top1 >= n - 1
        if "grad_norms" in e:
            got, plain_loss = grad_norms(cfg, params, batch)
            rel = {k: abs(got[k] - w) / w for k, w in e["grad_norms"].items()}
            worst = max(rel, key=rel.get)
            say(17, f"{arch} gradient (plain route, loss {plain_loss:.6f}): "
                    f"global norm {got['global']:.6f} vs "
                    f"{e['grad_norms']['global']:.6f} (relative "
                    f"{rel['global']:.2e}); {len(rel) - 1} xattn and encoder "
                    f"leaf norms, largest relative difference "
                    f"{rel[worst]:.2e} at {worst} (limit {GRAD_NORM_TOL})")
            assert all(math.isfinite(v) for v in got.values())
            assert max(rel.values()) <= GRAD_NORM_TOL, rel
        del params, logits, hidden
        free_card()
    return total


def phase_cross_serving(models: dict) -> dict:
    """Phase 18: two requests per model through ``prefill(frames= /
    img_embeds=)`` and ``decode_step``, greedy; the cross layers reach the
    kernel at prefill and at every decode step (one query row over the
    cached memory).  The first decode step's logits are held to the plain
    route's.  Returns the kernels' launches."""
    from repro_torch.models import model as M
    total = {"flash_attention": 0, "ssd_scan": 0}
    for arch, (cfg, params) in models.items():
        n_prompt, n_new = CROSS_PROMPT[arch], CROSS_NEW_TOKENS
        gen = torch.Generator(device=DEVICE).manual_seed(CROSS_SEED + 3)
        tokens = torch.randint(0, cfg.vocab, (2, n_prompt), generator=gen,
                               device=DEVICE)
        memory = memory_input(cfg, 2, gen)
        max_seq = n_prompt + n_new
        n_cross = sum(u.count("cross") * r for u, r in cfg.stages)
        encoder = (f", {cfg.encoder_layers} encoder layers"
                   if cfg.encoder_layers else "")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, _ = M.prefill(cfg, params, tokens, max_seq,
                                      **memory)
        out = [torch.argmax(logits[:, -1], -1)]
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        first = None
        for i in range(n_new - 1):
            logits, caches = M.decode_step(cfg, params, caches,
                                           out[-1][:, None], n_prompt + i)
            first = logits if first is None else first
            out.append(torch.argmax(logits[:, -1], -1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        want = n_cross + cfg.encoder_layers + (n_new - 1) * n_cross
        assert launches == {"flash_attention": want, "ssd_scan": 0}, (
            arch, launches, want)
        for k, v in launches.items():
            total[k] += v
        generated = torch.stack(out, 1)
        assert generated.shape == (2, n_new)
        assert bool(((generated >= 0) & (generated < cfg.vocab)).all())
        plain_cfg = dataclasses.replace(cfg, attn_impl="torch")
        _, plain_caches, _ = M.prefill(plain_cfg, params, tokens, max_seq,
                                       **memory)
        plain_first, _ = M.decode_step(plain_cfg, params, plain_caches,
                                       out[0][:, None], n_prompt)
        msg = logits_close(f"{arch} first decode step", first, plain_first)
        say(18, f"{arch}: 2 requests, {n_prompt}-token prompts over "
                f"{tuple(next(iter(memory.values())).shape)} memory, "
                f"{n_new} new tokens each: prefill {t_pre:.3f} s, "
                f"{n_new - 1} decode steps {wall - t_pre:.3f} s "
                f"({2 * (n_new - 1) / (wall - t_pre):.2f} tokens/s), "
                f"{2 * n_new / wall:.2f} tokens/s host wall clock incl. "
                f"prefill; flash launches {launches['flash_attention']} "
                f"({n_cross} cross layers at prefill and at each decode "
                f"step{encoder}); "
                f"first decode step vs the plain route: {msg} (limit "
                f"{SCORE_RMS_TOL}) [{CARD}]")
        del caches, plain_caches, logits
        free_card()
    return total


def phase_training() -> None:
    """Phase 19: mamba2-1.3b trained at full width through
    ``FaultTolerantTrainer`` + ``CheckpointManager`` + AdamW on the plain
    route, with one injected failure; then two ``make_train_step`` steps
    of whisper-small at full width with frames in the batch."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.ft import (FailureInjected, FaultTolerantTrainer,
                                TrainerConfig)
    from repro_torch.launch import steps, train
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(zoo_config(TRAIN["arch"], TRAIN["depth"]),
                              attn_impl="torch")
    assert cfg.remat
    ocfg = AdamWConfig(lr=TRAIN["lr"], clip_norm=1.0,
                       warmup_steps=TRAIN["warmup_steps"],
                       total_steps=TRAIN["steps"])
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                    global_batch=TRAIN["batch"]))
    step = steps.make_train_step(cfg, ocfg)
    calls, saved, checked, first, last = [], [], [], [], []

    def step_fn(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
        params, opt, m = step(state["params"], state["opt"], data)
        new = {"params": params, "opt": opt}
        if not first:
            first.append(data)     # its loss is the step's, at the start
        last[:] = [new]
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        calls.append({"tokens": batch["tokens"], "loss": loss,
                      "grad_norm": gnorm, "s": time.perf_counter() - t0})
        if len(calls) == TRAIN["checkpoint_every"]:
            # the state the trainer checkpoints at its first save, copied
            # on the card (the next steps update it in place) until its
            # restore
            saved.append(M.L.tree_map(torch.clone, new))
        return new, {"loss": loss, "grad_norm": gnorm}

    fired = []

    def hook(s):
        if s == TRAIN["fail_at"] and not fired:
            fired.append(s)
            raise FailureInjected(f"injected at step {s}")

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    trainer = FaultTolerantTrainer(
        TrainerConfig(checkpoint_dir=TRAIN_DIR,
                      checkpoint_every=TRAIN["checkpoint_every"]),
        step_fn, pipe, train.make_state_fns(cfg, ocfg, seed=TRAIN["seed"],
                                            device=DEVICE),
        failure_hook=hook)
    # keep the last checkpoint only: each holds 6.2 GB
    trainer.manager = CheckpointManager(TRAIN_DIR, keep=1)
    restore = trainer.manager.restore

    def checked_restore(target, *a, **k):
        tree, extra = restore(target, *a, **k)
        same = [torch.equal(x, y) for x, y in zip(
            M.L.tree_leaves(tree), M.L.tree_leaves(saved.pop()))]
        checked.append((sum(same), len(same), extra["step"]))
        return tree, extra
    trainer.manager.restore = checked_restore
    saves, save = [], trainer.manager.save

    def logged_save(step_no, *a, **k):
        saves.append(step_no)
        return save(step_no, *a, **k)
    trainer.manager.save = logged_save
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with host_clock(((trainer.manager, "save"), (trainer.manager, "restore"),
                     (ckpt, "_flatten"), (np, "savez"),
                     (trainer, "step_fn"))) as spent:
        t0 = time.perf_counter()
        out = trainer.run(TRAIN["steps"])
        trainer.manager.wait()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert launch_counts() == {"flash_attention": 0, "ssd_scan": 0}
    with torch.no_grad():
        after = float(M.loss_fn(cfg, last[0]["params"], first[0])[0])
    losses = [m["loss"] for m in out["metrics"]]
    norms = [m["grad_norm"] for m in out["metrics"]]
    secs = sorted(c["s"] for c in calls[1:])
    per_step = secs[len(secs) // 2]
    n_tok = TRAIN["batch"] * TRAIN["seq"]
    say(19, f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"remat, plain route (the SSD kernel has no backward); "
            f"{TRAIN['batch']} x {TRAIN['seq']} tokens from TokenPipeline, "
            f"{TRAIN['steps']} steps, checkpoint every "
            f"{TRAIN['checkpoint_every']}, failure injected at step "
            f"{TRAIN['fail_at']}: restarts {out['restarts']}, recovered "
            f"from {out['recovered_from']}, final step {out['final_step']}; "
            f"losses {[round(x, 4) for x in losses]}, grad norms "
            f"{[round(x, 4) for x in norms]}; the first batch's loss "
            f"{losses[0]:.4f} at the start, {after:.4f} after the last "
            f"step")
    say(19, f"{cfg.name}: {len(calls)} step calls, median {per_step:.3f} s "
            f"per step = {n_tok / per_step:.0f} tokens/s (first call "
            f"{calls[0]['s']:.3f} s); peak device memory {peak:.1f} GB; "
            f"run {wall:.1f} s host wall clock: steps {spent['step_fn']:.1f} "
            f"s, saves at steps {saves} {spent['save']:.1f} s "
            f"(device-to-host snapshots {spent['_flatten']:.1f} s, np.savez "
            f"{spent['savez']:.1f} s), restore {spent['restore']:.1f} s "
            f"(its bit-for-bit check included); "
            f"restored checkpoint: {checked[0][0]} of {checked[0][1]} leaves "
            f"equal bit for bit to the state saved at step {checked[0][2]} "
            f"[{CARD}]")
    assert out["restarts"] == 1 and out["recovered_from"] == [2]
    assert out["final_step"] == TRAIN["steps"]
    # the re-run of step 2 drew step 2's batch: the cursor was restored
    assert np.array_equal(calls[3]["tokens"], calls[2]["tokens"])
    assert not np.array_equal(calls[2]["tokens"], calls[1]["tokens"])
    assert all(math.isfinite(x) for x in losses + norms)
    # each step's loss is over another batch of uniform random tokens,
    # whose spread between batches (about 0.01) hides six steps' progress:
    # the fall is read on one batch, the first
    assert after < losses[0], (after, losses)
    assert checked == [(checked[0][1], checked[0][1], 2)], checked
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    del trainer, restore, save, first, last
    free_card()

    # whisper-small: two steps with frames in the batch
    wcfg = dataclasses.replace(zoo_config("whisper-small", None),
                               attn_impl="torch")
    params = M.init_params(wcfg, torch.Generator(device=DEVICE).manual_seed(
        TRAIN["seed"]), DEVICE)
    opt = adamw_init(params)
    wstep = steps.make_train_step(wcfg, ocfg)
    wpipe = TokenPipeline(DataConfig(vocab=wcfg.vocab,
                                     seq_len=WHISPER_TRAIN["seq"],
                                     global_batch=WHISPER_TRAIN["batch"]))
    gen = torch.Generator(device=DEVICE).manual_seed(TRAIN["seed"] + 1)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for _ in range(WHISPER_TRAIN["steps"]):
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in wpipe.next_batch().items()}
        batch.update(memory_input(wcfg, WHISPER_TRAIN["batch"], gen))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = wstep(params, opt, batch)
        rows.append((float(m["loss"]), float(m["grad_norm"]),
                     time.perf_counter() - t0))
    n_tok = WHISPER_TRAIN["batch"] * WHISPER_TRAIN["seq"]
    say(19, f"{wcfg.name}: {WHISPER_TRAIN['steps']} make_train_step steps "
            f"at full width (12 + 12 layers), {WHISPER_TRAIN['batch']} x "
            f"{WHISPER_TRAIN['seq']} tokens over {WHISPER_TRAIN['batch']} x "
            f"{wcfg.encoder_seq} frames: (loss, grad norm, s) {rows}; "
            f"{n_tok / rows[-1][2]:.0f} tokens/s at the second step; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
            f"[{CARD}]")
    assert all(math.isfinite(a) and math.isfinite(b) for a, b, _ in rows)
    assert all(math.isfinite(float(t.float().abs().max()))
               for t in M.L.tree_leaves(params))
    del params, opt
    free_card()



# ---------------------------------------------------------------------------
# Phase 20: the distribution layer on the card.
# ---------------------------------------------------------------------------
# h2o-danube-1.8b at full width with its depth cut to 12 of 24 layers
# (for the run's time: the four-card run of launch/multicard.py takes its
# gradients at full depth), the reference's own collective case (its
# hillclimb's "collective" cell, act_shard="none"), on the plain route
# with remat; the batch cut from the reference's 64 x 512 to 8 x 512 for
# one card's memory.  Each schedule is timed over DIST["reps"] calls
# after its checked one.  Serving: 2 requests, a 64-token prompt, 16 new
# tokens, attn_impl="seq_shard".
DIST = dict(arch="h2o-danube-1.8b", depth=12, batch=8, seq=512, reps=3,
            seed=23, prompt=64, new_tokens=16)
DIST_DIR = os.path.join(ROOT, "build", "chip_smoke_dist")
# int8 on the pod hop against the exact gradient, per element of each
# leaf: half an int8 step, scale / 2, to float32 rounding (the quotient
# x / scale and the product q * scale each round once, by at most 2**-17
# of the scale since |x| <= 127 * scale).
INT8_STEP_SHARE = 0.5 + 2 ** -16


def free_port() -> int:
    """A free TCP port on localhost for the process group's store."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_dist() -> None:
    """Phase 20: a one-rank NCCL process group and a (1, 1, 1) ``("pod",
    "data", "model")`` mesh on the card.  ``make_dp_grad_fn`` on
    h2o-danube-1.8b at full width under ``flat``, ``hier`` and ``hier`` +
    int8, held to the no-mesh value and gradient (bit for bit; int8
    within half a step); the same model served with
    ``attn_impl="seq_shard"``; ``reshard`` and a ``CheckpointManager``
    save + ``restore(shardings=...)`` of its parameters onto the mesh's
    placements, bit for bit.  The process group is global state, so this
    phase destroys it at its end (phase 21 brings up its own)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M

    port = free_port()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = mesh_mod.make_dev_mesh((1, 1, 1), ("pod", "data", "model"))
        say(20, f"process group: backend {dist.get_backend()}, world size "
                f"{dist.get_world_size()}; mesh {mesh_mod.describe(mesh)} "
                f"on {mesh.device_mesh.device_type}")
        cfg = dataclasses.replace(zoo_config(DIST["arch"], DIST["depth"]),
                                  attn_impl="torch", act_shard="none")
        assert cfg.remat
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(DIST["seed"]), DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(DIST["seed"] + 1)
        seqs = torch.randint(0, cfg.vocab, (DIST["batch"], DIST["seq"] + 1),
                             generator=gen, device=DEVICE)
        batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
        torch.cuda.synchronize()
        say(20, f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
                f"{cfg.param_count()} parameters from init_params on the "
                f"card in {time.perf_counter() - t0:.3f} s; batch "
                f"{DIST['batch']} x {DIST['seq']} tokens, plain route, "
                f"remat")
        dist_gradients(cfg, params, batch, mesh)
        dist_serving(cfg, params, mesh)
        dist_checkpoint(cfg, params, mesh)
        del params, batch
        free_card()
    finally:
        dist.destroy_process_group()


def dist_gradients(cfg, params, batch, mesh) -> None:
    """Phase 20's gradients: the no-mesh value and gradient, then each
    schedule held to it and timed."""
    import functools
    from repro_torch.dist import collectives, compression, context
    from repro_torch.dist import data_parallel
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    lf = functools.partial(M.loss_fn, cfg)
    n_tok = batch["tokens"].numel()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (want_loss, _), want = steps._value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    leaves = M.L.tree_leaves(want)
    # int8: one scale per reference leaf, a stage's repeats stacked as the
    # pod hop sends them
    stacked = M.L.tree_leaves(collectives.stack_repeats(want))
    scales = [float(compression.quantize(w)[1]) for w in stacked]
    del want
    rows = {}
    for name, kw in (("flat", dict(schedule="flat")),
                     ("hier", dict(schedule="hier")),
                     ("hier+int8", dict(schedule="hier", compress=True))):
        fn = data_parallel.make_dp_grad_fn(lf, mesh, **kw)
        torch.cuda.reset_peak_memory_stats()
        with context.use_mesh(mesh):
            loss, grads = fn(params, batch)
            got = M.L.tree_leaves(grads)
            if name == "hier+int8":
                excess = max(float((g - w).abs().max()) / s
                             for g, w, s in zip(M.L.tree_leaves(
                                 collectives.stack_repeats(grads)),
                                 stacked, scales))
                assert excess <= INT8_STEP_SHARE, (name, excess)
                equal = f"max |int8 - exact| {excess:.4f} of a step"
            else:
                same = sum(torch.equal(g, w) for g, w in zip(got, leaves))
                assert same == len(leaves), (name, same, len(leaves))
                equal = f"{same} of {len(leaves)} leaves equal bit for bit"
            assert torch.equal(loss, want_loss), (name, float(loss),
                                                  float(want_loss))
            del grads, got
            secs = []
            for _ in range(DIST["reps"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(params, batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        s = sorted(secs)[len(secs) // 2]
        rows[name] = s
        say(20, f"make_dp_grad_fn {name}: loss {float(loss):.6f} equal to "
                f"the no-mesh loss bit for bit, {equal}; {s:.3f} s per "
                f"gradient (median of {DIST['reps']}: "
                f"{[round(x, 3) for x in secs]}), {n_tok / s:.0f} tokens/s, "
                f"peak device memory {peak:.1f} GB [{CARD}]")
    assert launch_counts() == {"flash_attention": 0, "ssd_scan": 0}
    say(20, f"no-mesh value and gradient {plain_s:.3f} s (first call); "
            f"per-gradient seconds by schedule {rows} [{CARD}]")


def dist_serving(cfg, params, mesh) -> None:
    """Phase 20's serving: prefill + greedy decode with
    ``attn_impl="seq_shard"`` under the mesh, every decode attention
    through ``seq_sharded_attention``; the first decode step held to the
    plain route (``attn_impl="torch"``, no mesh) under phase 13's
    limits."""
    from repro_torch.dist import context, decode_attn
    from repro_torch.models import model as M
    scfg = dataclasses.replace(cfg, attn_impl="seq_shard")
    n_prompt, n_new = DIST["prompt"], DIST["new_tokens"]
    gen = torch.Generator(device=DEVICE).manual_seed(DIST["seed"] + 2)
    tokens = torch.randint(0, cfg.vocab, (2, n_prompt), generator=gen,
                           device=DEVICE)
    max_seq = n_prompt + n_new
    calls, real = [], decode_attn.seq_sharded_attention

    def counted(*a, **k):
        calls.append(a[0].shape[2])
        return real(*a, **k)
    decode_attn.seq_sharded_attention = counted
    reset_counts()
    try:
        with context.use_mesh(mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches, _ = M.prefill(scfg, params, tokens, max_seq)
            out = [torch.argmax(logits[:, -1], -1)]
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            first = None
            for i in range(n_new - 1):
                logits, caches = M.decode_step(scfg, params, caches,
                                               out[-1][:, None], n_prompt + i)
                first = logits if first is None else first
                out.append(torch.argmax(logits[:, -1], -1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        decode_attn.seq_sharded_attention = real
    assert launch_counts() == {"flash_attention": 0, "ssd_scan": 0}
    assert calls == [1] * ((n_new - 1) * cfg.n_layers), len(calls)
    generated = torch.stack(out, 1)
    assert generated.shape == (2, n_new)
    assert bool(((generated >= 0) & (generated < cfg.vocab)).all())
    plain_cfg = dataclasses.replace(cfg, attn_impl="torch")
    _, plain_caches, _ = M.prefill(plain_cfg, params, tokens, max_seq)
    plain_first, _ = M.decode_step(plain_cfg, params, plain_caches,
                                   out[0][:, None], n_prompt)
    msg = logits_close(f"{cfg.name} seq_shard first decode step", first,
                       plain_first)
    say(20, f"{cfg.name} served with attn_impl='seq_shard' under the mesh: "
            f"2 requests, {n_prompt}-token prompts, {n_new} new tokens "
            f"each: prefill {t_pre:.3f} s, {n_new - 1} decode steps "
            f"{wall - t_pre:.3f} s ({2 * (n_new - 1) / (wall - t_pre):.2f} "
            f"tokens/s); {len(calls)} seq_sharded_attention calls (one per "
            f"layer per decode step; a model axis of 1 takes its "
            f"single-device path); first decode step vs the plain route: "
            f"{msg} (limit {SCORE_RMS_TOL}) [{CARD}]")
    del caches, plain_caches, logits
    free_card()


def dist_checkpoint(cfg, params, mesh) -> None:
    """Phase 20's placements: ``reshard`` of the parameters onto
    ``param_shardings`` and a save + ``restore(shardings=...)``, every
    leaf's local shard equal to the saved leaf bit for bit."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist import sharding
    from repro_torch.ft import trainer
    from repro_torch.models import model as M
    shardings = sharding.param_shardings(cfg, mesh)
    leaves = M.L.tree_leaves(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = trainer.reshard(params, shardings)
    torch.cuda.synchronize()
    t_reshard = time.perf_counter() - t0
    same = sum(torch.equal(p.to_local(), w)
               for p, w in zip(M.L.tree_leaves(placed), leaves))
    assert same == len(leaves), ("reshard", same, len(leaves))
    del placed
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    mgr = CheckpointManager(DIST_DIR, keep=1)
    t0 = time.perf_counter()
    mgr.save(0, params)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, _ = mgr.restore(M.abstract_params(cfg), shardings=shardings)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    got = M.L.tree_leaves(restored)
    same_restored = sum(
        r.to_local().device == w.device and torch.equal(r.to_local(), w)
        for r, w in zip(got, leaves))
    assert same_restored == len(leaves), ("restore", same_restored)
    nbytes = sum(w.numel() * w.element_size() for w in leaves)
    placements = sorted({str(tuple(str(p) for p in s.placements))
                         for s in M.L.tree_leaves(shardings)})
    say(20, f"{cfg.name}: reshard onto param_shardings ({len(leaves)} "
            f"leaves, placements {placements}) {t_reshard:.3f} s, "
            f"{same} of {len(leaves)} local shards equal bit for bit; "
            f"CheckpointManager save of {nbytes / 1e9:.2f} GB "
            f"{t_save:.3f} s, restore(shardings=...) {t_restore:.3f} s, "
            f"{same_restored} of {len(leaves)} restored local shards on the "
            f"card equal to the saved leaves bit for bit [{CARD}]")
    del restored, got
    shutil.rmtree(DIST_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 21: the dry run on the card's terms.
# (a) fake dry runs at full size: (arch, shape, multi-pod, attn_override)
DRYRUN_FAKE = [("qwen2-7b", "decode_32k", False, "cuda"),
               ("h2o-danube-1.8b", "long_500k", False, None),
               ("mamba2-1.3b", "prefill_32k", True, "cuda")]
# (b) one-card runs, every layer at full width, the batch cut only for one
# card's memory: (arch, shape, batch, flash launches a step must make)
# the training cell's batch: of train_4k's 256 sequences of 4 096 tokens,
# as many as one card's memory holds with the parameters, the moments and
# remat's activations (fake census on the card: 17.4 GB of arguments and
# a 50.2 GB temp at 16; twice that at 32)
TRAIN_CELL_BATCH = 16
DRYRUN_REAL = [("h2o-danube-1.8b", "prefill_32k", 1, 0),
               ("qwen2-7b", "decode_32k", 8, 0),
               ("h2o-danube-1.8b", "long_500k", 1, 0),
               ("whisper-small", "decode_32k", 8, 12),
               ("mamba2-1.3b", "train_4k", TRAIN_CELL_BATCH, 0)]
DRYRUN_SEED = 29
# the predicted temp against the measured peak above the arguments
TEMP_BAND = 0.15


def phase_dryrun() -> None:
    """Phase 21 (see the module docstring)."""
    from repro_torch.launch import dryrun
    for arch, shape, multi, override in DRYRUN_FAKE:
        rec = dryrun.run_cell(arch, shape, multi, attn_override=override,
                              device=DEVICE)
        assert rec["status"] == "ok", (arch, shape, rec.get("traceback"))
        mem, r = rec["memory"], rec["roofline"]
        say(21, f"(a) fake {arch} {shape} on the {rec['mesh']} mesh "
                f"({rec['chips']} ranks, attn {override or 'default'}): "
                f"{rec['run_s']} s; per device args "
                f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
                f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB, outputs "
                f"{mem['output_size_in_bytes'] / 1e9:.3f} GB; "
                f"{rec['flops']:.4e} FLOPs, {rec['bytes_accessed']:.4e} "
                f"bytes accessed; collectives "
                f"{rec['collectives']['bytes_by_kind']}; roofline "
                f"(data-sheet prediction) compute {r['compute_s']:.4e} s, "
                f"memory {r['memory_s']:.4e} s, collective "
                f"{r['collective_s']:.4e} s, dominant {r['dominant']}")
    for arch, shape, batch, flash in DRYRUN_REAL:
        dryrun_one_card(arch, shape, batch, flash)


def storage_ptrs(tree) -> list[int]:
    """The storage address of every tensor of ``tree`` (a DTensor's local
    shard's)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import model as M
    return [(t.to_local() if isinstance(t, DTensor) else t)
            .untyped_storage().data_ptr() for t in M.L.tree_leaves(tree)]


def dryrun_one_card(arch: str, shape: str, batch: int, flash: int) -> None:
    """Phase 21(b): one cell fake on a one-rank fake mesh, then real on
    the card, held to each other (see the module docstring).  A training
    cell takes the plain route (no kernel has a backward), the others
    ``attn_override="cuda"``."""
    from repro_torch import configs
    from repro_torch.dist import context
    from repro_torch.launch import dryrun, shapes, steps
    from repro_torch.launch import mesh as mesh_mod
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = configs.get(arch)
    cell = dataclasses.replace(shapes.make_cell(arch, shape),
                               global_batch=batch)
    one = ((1, 1), ("data", "model"))
    override = None if cell.kind == "train" else "cuda"
    mesh = mesh_mod.make_fake_mesh(False, device=DEVICE, shape=one[0],
                                   axes=one[1])
    try:
        case = steps.make_case(cfg, cell, mesh, attn_override=override,
                               device=DEVICE)
        fake, fake_s = dryrun.run_case(case, mesh)
        roof = dryrun.roofline_terms(
            {**fake, "chips": 1, "kind": cell.kind, "seq_len": cell.seq_len,
             "global_batch": batch,
             "collective_bytes": fake["collectives"]["total_bytes"]},
            case.cfg)
        del case
        free_card()
        gen = torch.Generator(device=DEVICE).manual_seed(DRYRUN_SEED)
        real = steps.make_case(cfg, cell, mesh, attn_override=override,
                               device=DEVICE, fill=steps.real_fill(gen))
        # the arguments a step owns: its caches, or parameters + moments
        owned = {"decode": lambda a: a[1], "train": lambda a: a[:2]}.get(
            cell.kind)
        given = storage_ptrs(owned(real.args)) if owned else None
        torch.ones(8, 8, device=DEVICE) @ torch.ones(8, 8, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got, _ = dryrun.run_case(real, mesh)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with context.use_mesh(mesh), implicit_replication():
            out = real.fn(*real.args)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = launch_counts()
        same = storage_ptrs(owned(out)) == given if owned else None
        del out, real
        free_card()
    finally:
        mesh_mod.destroy_fake_mesh()
    assert fake["flops"] == got["flops"], (arch, shape, fake["flops"],
                                           got["flops"])
    args = fake["memory"]["argument_size_in_bytes"]
    assert args == got["memory"]["argument_size_in_bytes"], (
        arch, shape, args, got["memory"]["argument_size_in_bytes"])
    temp = fake["memory"]["temp_size_in_bytes"]
    miss = abs(temp - measured) / measured
    assert miss <= TEMP_BAND, (arch, shape, temp, measured, miss)
    assert launches["flash_attention"] == flash, (arch, shape, launches)
    assert same in (None, True), (arch, shape, "a second copy")
    owns = {None: "", True: "; the returned "
            + ("caches" if cell.kind == "decode" else
               "parameters and moments") + " are the arguments' storage "
            "(written in place)"}[same]
    say(21, f"(b) {arch} {shape} at batch {batch} of "
            f"{shapes.make_cell(arch, shape).global_batch}, one rank: fake "
            f"run {fake_s:.1f} s; FLOPs fake {fake['flops']:.6e} == real "
            f"{got['flops']:.6e}; argument bytes {args} == real; temp "
            f"predicted {temp / 1e9:.3f} GB vs measured peak above the "
            f"arguments {measured / 1e9:.3f} GB ({100 * miss:.1f} % apart, "
            f"band {100 * TEMP_BAND:.0f} %); step {step_s * 1e3:.1f} ms "
            f"measured vs roofline bound {roof['bound_s'] * 1e3:.3f} ms "
            f"({roof['dominant']}; {100 * roof['bound_s'] / step_s:.2f} % "
            f"of it); flash launches per step "
            f"{launches['flash_attention']}, ssd "
            f"{launches['ssd_scan']}{owns} [{CARD}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import noc_step

    t0 = time.perf_counter()
    phase_device()
    err = phase_parity()
    stat_launches, stream_launches = phase_main_path()
    launches = {noc_step.STATISTICAL: stat_launches,
                "streams": stream_launches}
    stat = phase_times()
    stream_stat = phase_stream_times()
    say(4, f"main path: {launches[noc_step.STATISTICAL]} launches, kernel "
           f"{stat['ms']:.3f} ms in all, twin {stat['plain_ms']:.1f} ms, "
           f"bound {stat['bound_ms']:.4f} ms [{CARD}]")
    stat["err"] = max(stat["err"], err)
    with open(TRACE_FAULT_REFERENCE) as f:
        ref = json.load(f)
    launches[noc_step.TRACE], trace_err, trace_exps = phase_trace(ref)
    records = phase_records()
    launches[noc_step.FAULTS], fault_err, fault_exps, fault_reports = (
        phase_faults(ref))
    timed = {}
    for mode, exps, e in ((noc_step.TRACE, trace_exps, trace_err),
                          (noc_step.FAULTS, fault_exps, fault_err)):
        rows = [time_launch(7, topo, cfgs, reps=3)
                for topo, cfgs in path_groups(exps, (mode,))]
        assert len(rows) == launches[mode], (mode, len(rows))
        timed[mode] = summed(rows)
        timed[mode]["err"] = max(timed[mode]["err"], e)
        say(7, f"{mode} path: {launches[mode]} launches, kernel "
               f"{timed[mode]['ms']:.3f} ms in all, twin "
               f"{timed[mode]['plain_ms']:.1f} ms, bound "
               f"{timed[mode]['bound_ms']:.4f} ms [{CARD}]")
    say(7, f"record walk (the MoE cell): {len(MOE_EXCHANGES)} launches, "
           f"kernel {records['ms']:.3f} ms in all, twin "
           f"{records['plain_ms']:.1f} ms, bound {records['bound_ms']:.4f} "
           f"ms [{CARD}]")
    timed[noc_step.STATISTICAL] = stat
    timed["streams"] = stream_stat
    timed.update(phase_kernels())
    model_launches, cfg, params = phase_scoring()
    launches.update(model_launches)
    phase_anchor()
    phase_serving(cfg, params)
    del cfg, params
    free_card()
    phase_analysis(ref, fault_reports)
    # each anchor's numpy weights are drawn on the host while the phase
    # before it keeps the card busy
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        trees = pool.submit(draw_anchor_trees, ZOO_REFERENCE, zoo_cut)
        for counts in (phase_zoo_scoring(), phase_zoo_anchor(
                trees.result())):
            for name, n in counts.items():
                launches[name] += n
        phase_zoo_serving()
        trees = pool.submit(draw_anchor_trees, CROSS_REFERENCE, cross_cut)
        counts, models = phase_cross_scoring()
        for phase_counts in (counts, phase_cross_anchor(trees.result()),
                             phase_cross_serving(models)):
            for name, n in phase_counts.items():
                launches[name] += n
    del models
    free_card()
    phase_training()
    phase_dist()
    phase_dryrun()
    say(21, f"whole run {time.perf_counter() - t0:.1f} s")
    names = (noc_step.STATISTICAL, noc_step.TRACE, noc_step.FAULTS,
             "flash_attention", "ssd_scan", "streams")
    record = {"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": timed[name]["err"], "ms": timed[name]["ms"],
        "plain_ms": timed[name]["plain_ms"],
        "bound_ms": timed[name]["bound_ms"],
        "bound_by": timed[name]["bound_by"],
        "library_ms": timed[name].get("library_ms")}
        for name in names]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
