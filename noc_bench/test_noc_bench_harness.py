"""The harness's arithmetic on synthetic timings, its seeded generators,
the kernel count from shapes, and the look for JAX and the reference
package by whole top-level names."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from noc_bench import generator, harness, roofline

CFG = {m: generator.load_json("configs", m)
       for m in ("ring_mesh-1024", "flat_mesh-1024")}
GRID = generator.load_json("traffic", "paper_grid")
REPAIR = generator.load_json("traffic", "resilience")
REPLAY = generator.load_json("traffic", "collectives")
CHANNELS = {"channels": np.arange(3, 900, 3)}


def fake_clock(durations, gap=0.0):
    """A clock that advances ``gap`` before and each duration during a
    step; ``step`` pops the next duration."""
    t = [0.0]

    def clock():
        return t[0]

    def step(i, now):
        t[0] += gap + durations[i]
    return clock, step


def test_window_ends_at_the_first_request_done_at_or_after_seconds():
    durations = [0.4, 0.4, 0.4, 3.0, 0.4, 0.4]
    clock, step = fake_clock(durations)
    seen = []
    elapsed = harness.window(lambda i, now: (seen.append(now),
                                             step(i, now)),
                             seconds=1.0, clock=clock)
    # The third request ends at 1.2 s >= 1.0: the window closes there,
    # neither cutting nor dropping it.
    assert seen == pytest.approx([0.0, 0.4, 0.8])
    assert elapsed == pytest.approx(1.2)
    clock, step = fake_clock(durations)
    # A long request that straddles the limit is waited for.
    assert harness.window(step, seconds=1.3, clock=clock) \
        == pytest.approx(4.2)


def test_a_pending_slice_holds_the_window_open(monkeypatch):
    monkeypatch.setattr(harness, "SLICE_S", 0.5)
    clock, step = fake_clock([0.4, 0.8, 0.4, 0.4, 0.4])
    # Quiet before 0.33, spans to 0.5; the second request straddles 0.5
    # and the end, so the third and fourth run under the profiler until
    # it has held 0.5 s.
    slc = harness.Slice(False, 1.0, clock=clock)
    modes = []
    elapsed = harness.window(
        lambda i, now: (modes.append(slc.enter(now)), step(i, now)), 1.0,
        clock=clock, pending=slc.pending)
    assert modes == ["quiet", "spans", "profiled", "profiled"]
    assert elapsed == pytest.approx(2.0)
    slc.close()


def test_after_sees_every_end_and_the_last():
    clock, step = fake_clock([0.5] * 4)
    calls = []
    harness.window(step, 1.0, clock=clock,
                   after=lambda now, last: calls.append((now, last)))
    assert calls == [(0.5, False), (1.0, True)]


def run_record(latencies, work=1000, points=12, mode="spans"):
    reqs = [dict(index=i, ok=True, mode=mode, latency_s=x, work=work,
                 points=points) for i, x in enumerate(latencies)]
    return dict(setup_s=12.5, elapsed_s=sum(latencies) + 0.5,
                requests=reqs, launches=[], profile={}, span_s={},
                calls={}, child_s={})


def test_rate_divides_all_work_by_the_whole_elapsed_time():
    rec = run_record([0.1] * 40)
    assert harness.reader("sim_rate")(rec) == pytest.approx(
        40 * 1000 / 4.5)
    assert harness.reader("setup_s")(rec) == 12.5


def test_p90_is_the_nearest_rank_of_all_requests():
    lat = [i / 100 for i in range(1, 201)]      # 0.01 .. 2.00
    rng = np.random.default_rng(0)
    rng.shuffle(lat)
    assert harness.reader("grid_job_s.p90")(run_record(lat)) == 1.80
    assert harness.reader("grid_job_s.p90")(run_record([0.3])) == 0.3


def test_per_point_spans_and_self_time():
    rec = run_record([0.2] * 5, points=4)
    rec["span_s"] = {"experiment.run_experiments": 1.0,
                     "sim.batch_operands": 0.2}
    rec["child_s"] = {"experiment.run_experiments": 0.6}
    assert harness.reader("streams.ms_per_point")(rec) == pytest.approx(10)
    assert harness.reader("experiment.self_ms_per_point")(rec) \
        == pytest.approx(20)
    # Nothing to read: no fault scenario, no certificate, no launch.
    for name in ("faults.host_ms_per_scenario", "fabric.certify_ms",
                 "noc_step_roofline", "noc_step.us_per_cycle", "job_mfu",
                 "device.idle_share"):
        assert harness.reader(name)(rec) is None
    # The spans divide by the points of the requests that ran under them.
    rec["requests"] += run_record([0.1] * 3, points=4,
                                  mode="quiet")["requests"]
    assert harness.reader("streams.ms_per_point")(rec) == pytest.approx(10)


def test_job_mfu_reads_the_quiet_requests_only():
    """The synchronised and profiled requests are slower: ``job_mfu``
    divides the quiet requests' launches by their wall time alone."""
    shape = dict(SHAPE, device_s=0.05)
    rec = run_record([0.3, 0.3], mode="quiet")
    slow = run_record([0.5, 0.5], mode="spans")["requests"]
    for r in slow:
        r["index"] += 2
    rec["requests"] += slow
    rec["launches"] = [dict(shape, request=i, mode=m) for i, m in
                       ((0, "quiet"), (1, "quiet"), (2, "spans"),
                        (3, "spans"))]
    assert harness.reader("job_mfu")(rec) == pytest.approx(
        100 * 2 * roofline.job_bound_s(shape) / 0.6)
    # The kernel's metrics read the quiet requests' launches too: the
    # others run the kernel's clocked twin (the program's telemetry on).
    for s in rec["launches"][2:]:
        s["device_s"] = 0.06
    assert harness.reader("noc_step.us_per_cycle")(rec) == pytest.approx(
        1e6 * 0.05 / 1500)
    assert harness.reader("noc_step_roofline")(rec) == pytest.approx(
        100 * roofline.kernel_bound_s(shape) / 0.05)


SHAPE = dict(lp1=7105, p=1024, np1=3585, fc=12, fi=12, batch=12,
             cycles=1500, n_phases=0, n_faults=0)


def test_kernel_count_reads_shapes_only():
    """One pass a cycle and point: the count is linear in batch x cycles
    and takes no argument the kernel's own run could move."""
    one = roofline.kernel_ops(dict(SHAPE, batch=1, cycles=1))
    assert roofline.kernel_ops(SHAPE) == 12 * 1500 * one
    assert one == (7105 * (12 + 14 + 4 * 12 + 12)
                   + 3585 * (4 * 12 + 2) + 7105 * 12)
    assert roofline.stream_bytes(SHAPE) == 12 * 1500 * 1024 * 3
    launch = dict(SHAPE, device_s=0.05, mode="quiet")
    share = harness.reader("noc_step_roofline")(dict(launches=[launch]))
    assert share == pytest.approx(
        100 * roofline.kernel_bound_s(SHAPE) / 0.05)
    assert 0 < share < 100


def test_kernel_count_matches_chip_smoke_at_one_pass_per_cycle():
    """``chip_smoke.bound_ms`` with its pass count set to one a cycle and
    point, and no faults, is the same arithmetic."""
    torch = pytest.importorskip("torch")
    import chip_smoke
    from repro_torch.core import sim
    from repro_torch.core.spec import TopologySpec
    geom = sim.build_geometry(TopologySpec("ring_mesh", 64).build(), "cpu")
    inj = torch.zeros((3, 200, 64), dtype=torch.bool)
    shape = roofline.launch_shape(geom, inj)
    passes = torch.full((3,), 200, dtype=torch.int32)
    ms, _ = chip_smoke.bound_ms(geom, 3, 200, passes)
    assert roofline.kernel_bound_s(shape) * 1e3 == pytest.approx(ms)


@pytest.mark.parametrize("seed", [0, 7, 3_000_000_001, 2 ** 40 + 5, -3])
def test_generator_is_seeded_and_fresh(seed):
    for cfg, mix, ch in ((CFG["ring_mesh-1024"], GRID, None),
                         (CFG["flat_mesh-1024"], GRID, None),
                         (CFG["ring_mesh-1024"], REPAIR, CHANNELS),
                         (CFG["ring_mesh-1024"], REPLAY, None)):
        a = generator.Generator(cfg, mix, seed, ch)
        b = generator.Generator(cfg, mix, seed, ch)
        work = generator.entry(mix["entry"]).work
        reqs = [a.request(i) for i in range(6)]
        assert reqs == [b.request(i) for i in range(6)]
        assert a.warmup() == b.warmup() and a.warmup() not in reqs
        other = generator.Generator(cfg, mix, seed + 1, ch).request(0)
        assert other != reqs[0]
        if mix["entry"] == "run_experiments":
            seeds = [p["seed"] for r in reqs for p in r["points"]]
            assert len(reqs[0]["points"]) == 12
            assert work(reqs[0]) == 12 * 1024 * 1500
        elif mix["entry"] == "trace_replay":
            seeds = [r["point"]["seed"] for r in reqs]
            assert [r["schedule"] for r in reqs] == [
                "flat", "hier", "hier_int8"] * 2
            assert work(reqs[0]) == 1024 * 4000
            ups = a.warmups()
            assert [r["schedule"] for r in ups] == ["flat", "hier",
                                                    "hier_int8"]
            assert not [r for r in ups if r in reqs]
        else:
            seeds = [r["point"]["seed"] for r in reqs]
            placed = [tuple(r["dead_links"]) for r in reqs]
            assert len(set(placed)) == len(placed)
            assert [len(p) for p in placed] == [2, 4, 8, 2, 4, 8]
            assert all(set(p) <= set(CHANNELS["channels"].tolist())
                       for p in placed)
            assert work(reqs[0]) == 3 * 1024 * 1200
        assert len(set(seeds)) == len(seeds)
        assert all(0 <= s < 2 ** 31 for s in seeds)


def test_a_pattern_listed_twice_is_a_second_point_with_its_own_seed():
    """More points a grid (several seeds a pattern and rate) are a data
    file's matter: list the patterns again."""
    mix = dict(GRID, patterns=GRID["patterns"] * 8)
    req = generator.Generator(CFG["ring_mesh-1024"], mix, 9).request(0)
    assert generator.entry("run_experiments").points(req) == 96
    assert len({p["seed"] for p in req["points"]}) == 96


@pytest.mark.parametrize("mix", ["paper_grid", "resilience",
                                 "collectives"])
def test_each_mix_finds_its_entry_by_name(mix):
    ent = generator.entry(generator.load_json("traffic", mix)["entry"])
    for fn in ("context", "request", "run", "reference", "work", "points"):
        assert callable(getattr(ent, fn))
    assert generator.entry(ent.__name__.split("noc_bench_entry_")[1]) is ent
    with pytest.raises(ValueError, match="unknown entry"):
        generator.entry("no_such_entry")


def test_fault_placement_is_the_programs_sampler():
    """A seeded placement equals ``faults.sample_faults`` on the same
    channels and seed (the program's generator, copied)."""
    from repro_torch.core.spec import TopologySpec
    from repro_torch.faults.spec import fabric_channels, sample_faults
    from noc_bench.reference import noc
    topo = TopologySpec("ring_mesh", 64, src_queue_depth=8).build()
    ours = noc.fabric_channels(noc.build(dict(
        family="ring_mesh", n_pes=64, queue_depth=2, src_queue_depth=8)))
    assert np.array_equal(ours, fabric_channels(topo))
    for s in (0, 11, 2 ** 31 - 2):
        want = sample_faults(topo, n_dead_links=4, seed=s).dead_links
        got = np.random.default_rng(s).choice(ours, size=4, replace=False)
        assert tuple(int(c) for c in got) == want


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("repro_torch.core", "jaxtyping", "reprobe", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not [m for m in harness.forbidden_modules()
                if m in ("repro_torch.core", "jaxtyping", "reprobe",
                         "flaxen")]
    for name in ("repro.core", "jax.numpy", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in harness.forbidden_modules()


BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [{root!r}, {src!r}]
from noc_bench import harness, program, check, tracing, roofline
from noc_bench.reference import noc, fabric, collectives
program.modules()
man = harness.manifest()
for m in man["end_to_end"] + man["per_layer"]:
    harness.reader(m["name"])
assert not harness.forbidden_modules(), harness.forbidden_modules()
print("clean")
"""


def test_nothing_the_benchmark_runs_imports_jax_or_the_reference():
    src = os.path.join(harness.ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(root=harness.ROOT, src=src)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            with open(os.path.join(ref, name)) as f:
                text = f.read()
            for bad in ("repro_torch", "import jax", "from jax",
                        "from repro", "import repro"):
                assert bad not in text, (name, bad)


def test_no_cell_repeats_a_point():
    g = generator.Generator(CFG["ring_mesh-1024"], GRID, 5)
    pts = [json.dumps(p, sort_keys=True) for r in map(g.request, range(20))
           for p in r["points"]]
    assert len(pts) == 240 and len(set(pts)) == len(pts)
