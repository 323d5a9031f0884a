"""The manifest keeps to the benchmark's contract, and every configuration,
traffic mix and metric it names is found by name in a file of its own."""
import json
import os
import re

import pytest

from noc_bench import generator, harness

MAN = harness.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
LINE = re.compile(r"[^\t\n]{1,200}\Z")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["noc_bench"]
    assert 1 <= len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word.split("/")
    assert os.path.isfile(os.path.join(harness.ROOT, MAN["command"][1]))
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    size = os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_configuration(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert LINE.match(entry["source"]) and LINE.match(entry["why"])
    assert entry["file"].startswith("noc_bench/")
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["source"] == entry["source"]
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("wl", MAN["workloads"], ids=lambda w: w["name"])
def test_workload(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(wl["name"]) and NAME.match(wl["traffic"])
    assert wl["chips"] == 1
    assert LINE.match(wl["why"])
    assert wl["config"] in {c["name"] for c in MAN["configs"]}
    mix = generator.load_json("traffic", wl["traffic"])
    assert os.path.isfile(os.path.join(harness.HERE, "entries",
                                       f"{mix['entry']}.py"))
    e2e = harness.metrics_of(MAN, wl["name"], traced=False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.metrics_of(MAN, wl["name"], traced=True)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    e2e = m in MAN["end_to_end"]
    keys = ({"name", "unit", "better", "bound", "source"} if e2e
            else {"name", "unit", "better", "source", "layer", "moves"})
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    if e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert LINE.match(m["layer"])
        assert m["moves"] in {x["name"] for x in MAN["end_to_end"]}
    names = {w["name"] for w in MAN["workloads"]}
    assert set(m.get("workloads", names)) <= names
    assert callable(harness.reader(m["name"]))


def test_names_are_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_shares_are_named_for_their_peak():
    for m in MAN["per_layer"]:
        if m["unit"] == "%" and m["better"] == "higher":
            assert m["name"].endswith("_roofline") or "mfu" in m["name"]


def test_a_check_fits_its_time():
    n = 24   # the most cells a later benchmark may have
    runs = 2 + 14 * n
    assert runs * (MAN["run_seconds"] + 60) + n * 180 + 1200 <= 43200
