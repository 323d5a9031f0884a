"""The one generator of requests: a traffic mix's parameters and a seed in,
the request with index ``i`` out, as plain dicts that both the program's
side and the plain reference read.

A mix file (``traffic/<name>.json``) names its ``entry``, and the entry is
a file of its own, ``entries/<entry>.py``, found by that name.  It gives:

* ``context(config, mix) -> dict``: what every request of a run shares,
  worked out once on the reference's side (a fault mix's channels);
* ``request(gen, rng, i) -> dict``: request ``i`` from this generator's
  configuration, mix and context and a seeded ``rng``;
* ``run(request, captured, backend, device)``: the program's entry;
* ``reference(request, device, precision="float32") -> dict``: the plain
  reference's outputs, in ``program.outputs``' form;
* ``work(request)``: simulated PE-cycles; ``points(request)``: simulated
  points (or legs);
* optionally ``warmups(gen) -> list[dict]``: the set-up's requests, where
  one request does not run every shape the window sends.

``locality`` and ``budget`` of a mix are ``"config"`` (the
configuration's own) or explicit values.  Every point seed and fault
placement is drawn from (``--seed``, ``i``), so no two requests of a run
share either; request ``i`` of one seed is the same in every run.
``warmup()`` draws one more request of the same mix that no measured
request equals.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED_MAX = 2 ** 31 - 1   # the program takes int32 point seeds


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


@functools.cache
def entry(name: str):
    """The module of ``entries/<name>.py``."""
    path = os.path.join(HERE, "entries", f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"unknown entry {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        f"noc_bench_entry_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rng(seed: int, *words: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, *words])


class Generator:
    """Requests of ``mix`` on ``config`` from ``seed``.  ``context``
    replaces the entry's own (the CPU tests give a fault mix synthetic
    channels rather than build a 1024-PE fabric)."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 context: dict | None = None):
        self.config, self.mix, self.seed = config, mix, seed
        self.entry = entry(mix["entry"])
        self.context = (self.entry.context(config, mix) if context is None
                        else context)

    def point(self, pattern: str, inj_rate: float, seed: int) -> dict:
        """One simulated point on the configuration's fabric."""
        cfg, mix = self.config, self.mix
        loc = (dict(locality_ringlet=cfg["locality_ringlet"],
                    locality_block=cfg["locality_block"])
               if mix["locality"] == "config" else dict(mix["locality"]))
        bud = (dict(cycles=cfg["cycles"], warmup=cfg["warmup"])
               if mix["budget"] == "config" else dict(mix["budget"]))
        return dict(pattern=pattern, inj_rate=float(inj_rate), seed=seed,
                    starvation_limit=cfg["starvation_limit"],
                    dead_links=[], **loc, **bud)

    def request(self, i: int) -> dict:
        return self.entry.request(self, _rng(self.seed, 1, i), i)

    def warmup(self) -> dict:
        return self.entry.request(self, _rng(self.seed, 0), 0)

    def warmups(self) -> list[dict]:
        """The set-up's requests: the entry's own, else ``warmup()``."""
        own = getattr(self.entry, "warmups", None)
        return own(self) if own is not None else [self.warmup()]
