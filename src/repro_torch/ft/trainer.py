"""Fault tolerance: restartable training, straggler detection, elastic
rescale — the system-level reading of the paper's morphing (§5.1).  The
port of ``repro.ft.trainer``: host logic, copied as it is, on the port's
``CheckpointManager``; ``reshard`` places a tree on a mesh's shardings as
DTensors.

    Bypass     -> a failed worker's step is retried / its shard re-routed
    Switch-off -> the fleet shrinks: rebuild the mesh, reshard from the
                  last checkpoint, continue
    ERS resize -> the fleet grows the same way

``FaultTolerantTrainer`` wraps a step function with checkpoint/restart;
failures (real exceptions or injected ones) roll back to the last durable
step.  ``StragglerDetector`` flags slow hosts from per-step timing EMAs —
at kilocore scale the paper's priority/aging arbitration becomes backup
workers + re-dispatch, which the detector's report drives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager


class FailureInjected(RuntimeError):
    """Raised by the failure-injection hook (tests / chaos drills)."""


@dataclasses.dataclass
class TrainerConfig:
    checkpoint_dir: str
    checkpoint_every: int = 50
    max_restarts: int = 3
    async_save: bool = False


@dataclasses.dataclass
class StragglerDetector:
    """EMA-based straggler detection over per-host step durations.

    A host is a straggler when its EMA exceeds ``threshold`` x the median
    EMA across hosts — the signal a scheduler uses to re-dispatch that
    host's shard (paper: low-priority traffic aging, applied to workers).
    """

    num_hosts: int
    alpha: float = 0.2
    threshold: float = 1.5

    def __post_init__(self):
        self.ema = np.zeros(self.num_hosts)
        self.seen = np.zeros(self.num_hosts, dtype=bool)

    def observe(self, host: int, duration: float) -> None:
        if not self.seen[host]:
            self.ema[host] = duration
            self.seen[host] = True
        else:
            self.ema[host] = (1 - self.alpha) * self.ema[host] \
                + self.alpha * duration

    def stragglers(self) -> list[int]:
        if not self.seen.any():
            return []
        med = float(np.median(self.ema[self.seen]))
        if med <= 0:
            return []
        return [int(h) for h in range(self.num_hosts)
                if self.seen[h] and self.ema[h] > self.threshold * med]


class FaultTolerantTrainer:
    """Checkpoint/restart driver around a pure step function.

    step_fn(state, batch) -> (state, metrics);  state is any pytree
    (params/opt/...), data_state round-trips through the pipeline's
    ``state()/restore()``.
    """

    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 pipeline, init_state_fn: Callable[[], Any],
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.init_state_fn = init_state_fn
        self.failure_hook = failure_hook
        self.manager = CheckpointManager(cfg.checkpoint_dir)
        self.restarts = 0
        self.recovered_from: list[int] = []

    # -- persistence ---------------------------------------------------------
    def _save(self, step: int, state: Any) -> None:
        self.manager.save(step, state,
                          extra={"data_state": self.pipeline.state(),
                                 "step": step},
                          blocking=not self.cfg.async_save)

    def _restore(self) -> tuple[int, Any]:
        latest = self.manager.latest_step()
        if latest is None:
            return 0, self.init_state_fn()
        target = self.init_state_fn()
        state, extra = self.manager.restore(target)
        self.pipeline.restore(extra["data_state"])
        return int(extra["step"]), state

    # -- main loop ----------------------------------------------------------
    def run(self, total_steps: int) -> dict:
        step, state = self._restore()
        metrics_log = []
        while step < total_steps:
            try:
                t0 = time.monotonic()
                if self.failure_hook is not None:
                    self.failure_hook(step)
                batch = self.pipeline.next_batch()
                state, metrics = self.step_fn(state, batch)
                dt = time.monotonic() - t0
                metrics_log.append({"step": step, "dt": dt, **metrics})
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self._save(step, state)
            except FailureInjected:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                # restart: roll back to the last durable checkpoint
                self.manager.wait()
                step, state = self._restore()
                self.recovered_from.append(step)
        self.manager.wait()
        self._save(step, state)
        return {"final_step": step, "restarts": self.restarts,
                "recovered_from": self.recovered_from,
                "metrics": metrics_log}


def reshard(tree, shardings):
    """Elastic rescale: move a tree (host tensors, arrays, or DTensors laid
    out for another mesh) onto a new mesh's shardings, a matching tree of
    ``dist.sharding.NamedSharding``s.  Each leaf goes through
    ``distribute_tensor`` onto its placements (``sharding.place``): a
    DTensor of which each rank holds its local shard."""
    from repro_torch.dist import sharding
    from repro_torch.models.layers import tree_map
    return tree_map(sharding.place, tree, shardings)
