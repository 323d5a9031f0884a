"""``repro_torch.launch.multicard`` in its gloo form: four spawned CPU
ranks run ``multicard.main(["--device", "cpu"])`` (every check at smoke
size), and rank 0's JSON lines are read back, one test case per check.

One subprocess runs this file as a script; it spawns the 4 ranks
(``torch.multiprocessing``), each with the environment ``torchrun``
would give it.  On four cards the same script runs with NCCL at the
published widths (``torchrun --standalone --nproc-per-node 4 -m
repro_torch.launch.multicard``).
"""
import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = ("dp_grads", "ring_decode", "moe", "reshard", "train_step",
          "census")


def _rank(rank: int, port: int, out: str) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="4",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from repro_torch.launch import multicard
    assert multicard.main(["--device", "cpu", "--out", out]) == 0


def main(out: str) -> None:
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.spawn(_rank, args=(port, out), nprocs=4)


if __name__ == "__main__":
    main(sys.argv[1])


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multicard") / "lines.jsonl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out) as f:
        return [json.loads(line) for line in f]


def test_every_check_ran_and_the_last_line_says_ok(lines):
    assert [line.get("check") for line in lines[:-1]] == list(CHECKS)
    assert lines[-1]["ok"] is True and lines[-1]["world"] == 4
    assert lines[-1]["backend"] == "gloo"


@pytest.mark.parametrize("check", CHECKS)
def test_check_holds_on_every_rank(lines, check):
    line = next(x for x in lines if x.get("check") == check)
    assert line["ok"], line
    assert line.get("failed_ranks", []) == []


def test_moe_check_drops_tokens_and_ring_writes_in_place(lines):
    """The MoE check cannot pass without capacity binding, and the ring
    decode keeps each rank's chunk of the cache, written in place."""
    by = {x.get("check"): x for x in lines}
    moe = by["moe"]["rank0"]
    assert moe["dropped_pairs"] > 0, moe
    ring = by["ring_decode"]["rank0"]
    assert ring["in_place"] and ring["cache_chunk_shape"][2] == 16, ring


def test_census_real_equals_fake_by_kind(lines):
    cells = next(x for x in lines if x.get("check") == "census")["rank0"]
    for name, cell in cells["cells"].items():
        assert cell["real"]["bytes_by_kind"] == cell["fake"]["bytes_by_kind"]
        assert cell["real"]["bytes_by_kind"], name
