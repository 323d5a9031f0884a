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


# A key that names a width: the contract never lets ``reduced`` cut one.
WIDTH = re.compile(r"(_dim|_rank)\Z|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_tok")


def configuration_faults(entry: dict, cfg: dict) -> list[str]:
    """What keeps a configuration's manifest entry and its file from the
    contract.  ``reduced`` lists each key cut from the source, the same in
    both; the file's ``cuts`` gives each such key its ``published`` value,
    the value ``used`` (the file's own where the key is at its top level)
    and ``why``."""
    faults = []
    if set(entry) != {"name", "source", "file", "reduced", "why"}:
        faults.append(f"entry keys {sorted(entry)}")
    if not (NAME.match(entry["name"]) and LINE.match(entry["source"])
            and LINE.match(entry["why"])):
        faults.append("name, source or why")
    if not entry["file"].startswith("noc_bench/"):
        faults.append("file outside the benchmark")
    if cfg.get("name") != entry["name"] or \
            cfg.get("source") != entry["source"]:
        faults.append("file's name or source")
    cut = entry["reduced"]
    if cfg.get("reduced") != cut:
        faults.append("reduced differs between the manifest and the file")
    if not isinstance(cut, list) or len(cut) > 16 \
            or len(set(cut)) != len(cut):
        return faults + ["reduced is not a list of at most 16 keys"]
    for key in cut:
        if not NAME.match(key):
            faults.append(f"reduced key {key!r} is no name")
        elif WIDTH.search(key):
            faults.append(f"reduced key {key!r} is a width")
    cuts = cfg.get("cuts", {})
    if set(cuts) != set(cut):
        faults.append("cuts do not name the reduced keys")
    for key in set(cuts) & set(cut):
        c = cuts[key]
        if set(c) != {"published", "used", "why"} or \
                c["published"] == c["used"] or not LINE.match(c["why"]):
            faults.append(f"cut of {key!r}")
        elif key in cfg and cfg[key] != c["used"]:
            faults.append(f"{key!r} in the file is not the value used")
    return faults


def entry_and_file(entry: dict) -> tuple[dict, dict]:
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        return entry, json.load(f)


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_configuration(entry):
    assert configuration_faults(*entry_and_file(entry)) == []
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


def test_the_published_configurations_are_uncut():
    for entry in MAN["configs"]:
        assert entry_and_file(entry)[1]["reduced"] == entry["reduced"] == []


def cut_configuration(entry_change=None, file_change=None):
    """A synthetic configuration that cuts one key, ``cycles``, with the
    changes given to its manifest entry and its file."""
    entry, cfg = entry_and_file(MAN["configs"][0])
    entry = dict(entry, reduced=["cycles"])
    cfg = dict(cfg, reduced=["cycles"], cycles=750, cuts={"cycles": dict(
        published=1500, used=750, why="half the budget, to fit the check")})
    entry.update(entry_change or {})
    cfg.update(file_change or {})
    return entry, cfg


def test_a_configuration_may_declare_a_cut():
    assert configuration_faults(*cut_configuration()) == []


@pytest.mark.parametrize("entry_change,file_change,fault", [
    (dict(reduced=[]), None, "differs between the manifest and the file"),
    (None, dict(reduced=["cycles", "warmup"]), "differs"),
    (None, dict(cuts={}), "cuts do not name"),
    (None, dict(cycles=1500), "not the value used"),
    (None, dict(cuts={"cycles": dict(published=1500, used=1500, why="x")}),
     "cut of"),
])
def test_a_cut_that_does_not_match_fails(entry_change, file_change, fault):
    faults = configuration_faults(*cut_configuration(entry_change,
                                                     file_change))
    assert any(fault in f for f in faults), faults


def test_a_width_may_not_be_cut():
    entry, cfg = cut_configuration()
    for key in ("hidden_size", "head_dim", "kv_lora_rank",
                "num_experts_per_tok", "moe_intermediate_size"):
        cut = dict(cfg["cuts"]["cycles"], published=2, used=1)
        faults = configuration_faults(
            dict(entry, reduced=[key]),
            dict(cfg, reduced=[key], cuts={key: cut}))
        assert any("is a width" in f for f in faults), (key, faults)


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
