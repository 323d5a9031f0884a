"""The port stands alone: no jax, nothing of the reference package.

``src/repro_torch`` and ``chip_smoke.py`` must import neither ``jax`` nor
``repro`` (not even its numpy-only modules, whose package ``__init__``
pulls jax in).  Checked twice: statically, over every import statement,
and dynamically, by importing every port module in a fresh interpreter in
which importing jax or repro fails.  The port's CUDA backend must raise,
not fall back, where there is no card.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PORT):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, os.path.join(ROOT, "src"))
        if rel.startswith("repro_torch"):
            mods.append(rel[:-3].replace(os.sep, ".").replace(
                ".__init__", ""))
    return mods


def test_no_forbidden_import_statements():
    files = _port_files()
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import importlib
for m in {modules!r}:
    importlib.import_module(m)
from repro_torch.core import Experiment, TopologySpec
from repro_torch.core.experiment import Budget
rep = Experiment(topology=TopologySpec("ring_mesh", 16), inj_rate=0.3,
                 budget=Budget(cycles=60, warmup=10, backend="torch",
                               device="cpu")).run()
assert rep.sim.delivered > 0
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
assert not leaked, leaked
print("ok", len({modules!r}))
"""


def test_port_imports_and_runs_with_jax_and_repro_blocked():
    mods = _modules()
    code = _BLOCKER.format(forbidden=set(FORBIDDEN), modules=mods)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"ok {len(mods)}"


def test_cuda_backend_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core import experiment, sim, spec
    topo = spec.TopologySpec("ring_mesh", 16).build()
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.simulate(topo, sim.SimConfig(cycles=20, warmup=0))
    exp = experiment.Experiment(topology=spec.TopologySpec("flat_mesh", 16),
                                budget=experiment.Budget(cycles=20,
                                                         warmup=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        exp.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        experiment.run_experiments([exp])


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Run alone, in a directory holding only the script: it must exit
    non-zero and print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        script.write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
