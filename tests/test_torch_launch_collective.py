"""``launch.hillclimb.climb_collective`` against the reference's census of
the same cell (``experiments/hillclimb/collective_schedules.json``, from
its compiled HLO): h2o-danube-1.8b's gradient at 64 x 512 tokens through
``make_dp_grad_fn`` on the 512-rank multi-pod fake mesh, fake tensors.
"""
from __future__ import annotations

import json
import os

import pytest

from repro_torch.launch import hillclimb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "experiments", "hillclimb",
                         "collective_schedules.json")


@pytest.fixture(scope="module")
def censuses(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hillclimb"))
    got = hillclimb.climb_collective(out=out)
    with open(os.path.join(out, "collective_schedules.json")) as f:
        assert json.load(f) == json.loads(json.dumps(got))
    with open(REFERENCE) as f:
        return got, json.load(f)


@pytest.mark.parametrize("schedule", ["flat", "hier"])
def test_bytes_by_kind_equal_reference(censuses, schedule):
    """Per-device operand bytes by kind equal the reference's (flat: the
    7 324 805 124-byte all-reduce; hier: 7 324 805 120 reduce-scattered,
    457 800 324 all-reduced across pods, 457 800 320 gathered back).
    Counts may differ: XLA combines the ops of several leaves."""
    got, ref = censuses
    assert got[schedule]["bytes_by_kind"] == ref[schedule]["bytes_by_kind"]


def test_int8_pod_hop_gathers_the_same_codes(censuses):
    """hier + int8: per-device operand bytes by kind equal the
    reference's exactly (the 7 324 805 124-byte in-pod all-reduce; the pod
    hop's all-gather of 1 831 201 328 bytes: the int8 codes beside one
    float32 scale per reference leaf, a stage's repeats stacked into one
    leaf as the reference stacks them)."""
    got, ref = censuses
    g, r = got["hier_int8"], ref["hier_int8"]
    assert g["bytes_by_kind"] == r["bytes_by_kind"]
    assert g["bytes_by_kind"]["all-gather"] == 1_831_201_328
