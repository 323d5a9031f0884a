"""Batched serving engine: fixed-slot continuous batching (the port of
``repro.serve.engine``).

The engine keeps ``n_slots`` decode slots over one shared KV/state cache.
Incoming requests queue up; free slots are refilled between decode steps
(prefill writes the prompt into the slot's cache rows).  One engine tick
advances every active slot by a token, one decode per distinct position,
as the reference groups them.  Greedy sampling; per-slot stop at
``max_new_tokens``, at EOS, or one short of ``max_seq``.

Where the reference merges a decode's new caches into the shared ones
with ``jnp.where`` over all slots, this engine writes the stepped slots'
rows into the shared cache tensors in place.  A leaf whose dtype the
decode widened (a bfloat16 conv state that met float32 activations) is
widened in the shared cache first, as ``jnp.where`` would promote it.
Prefill and decode run the plain routes, as in the reference: a call with
a cache never reaches the CUDA kernels.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models import config as mcfg
from repro_torch.models import layers as L
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos: Optional[int] = None
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _write_rows(shared, new, rows):
    """Write ``new``'s batch rows ``rows`` into the tree ``shared`` in
    place (batch is each leaf's first axis); returns the tree, with any
    leaf replaced whose dtype had to widen."""
    if isinstance(shared, dict):
        return {k: _write_rows(shared[k], new[k], rows) for k in shared}
    if isinstance(shared, list):
        return [_write_rows(s, n, rows) for s, n in zip(shared, new)]
    dtype = torch.promote_types(shared.dtype, new.dtype)
    if dtype != shared.dtype:
        shared = shared.to(dtype)
    shared[rows] = new[rows].to(dtype)
    return shared


class ServeEngine:
    def __init__(self, cfg: mcfg.ModelConfig, params, *, n_slots: int = 4,
                 max_seq: int = 128):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = params["embed"].device
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, dtype=np.int64)
        self.caches = M.init_cache(cfg, n_slots, max_seq, device=self.device)

    # -- host-side scheduling ---------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _refill(self) -> None:
        """Prefill queued requests into free slots, one at a time: the
        prompt runs with a batch-1 cache whose rows are then copied into
        the shared cache at the slot (in the shared cache's dtype, as the
        reference's ``.at[].set`` does)."""
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            prompt = torch.tensor([req.prompt], dtype=torch.long,
                                  device=self.device)
            logits, cache1, _ = M.prefill(self.cfg, self.params, prompt,
                                          max_seq=self.max_seq)

            def write(shared, one):
                shared[slot:slot + 1] = one
                return shared
            self.caches = L.tree_map(write, self.caches, cache1)
            req.output.append(int(torch.argmax(logits[0, -1])))
            self.slots[slot] = req
            self.slot_pos[slot] = len(req.prompt)

    def _retire(self) -> None:
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if len(req.output) >= req.max_new_tokens or \
                    (req.eos is not None and req.output
                     and req.output[-1] == req.eos) or \
                    self.slot_pos[i] >= self.max_seq - 1:
                req.done = True
                self.slots[i] = None

    @torch.no_grad()
    def step(self) -> int:
        """One engine tick: refill, decode every active slot, retire."""
        self._refill()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        # one decode per distinct position; every slot rides along, and
        # only the group's rows are kept
        for pos in sorted({int(self.slot_pos[i]) for i in active}):
            group = [i for i in active if int(self.slot_pos[i]) == pos]
            toks = torch.zeros((self.n_slots, 1), dtype=torch.long)
            for i in group:
                toks[i, 0] = self.slots[i].output[-1]
            logits, new_caches = M.decode_step(
                self.cfg, self.params, self.caches, toks.to(self.device), pos)
            rows = torch.tensor(group, dtype=torch.long, device=self.device)
            self.caches = _write_rows(self.caches, new_caches, rows)
            best = torch.argmax(logits[:, -1], dim=-1).tolist()
            for i in group:
                self.slots[i].output.append(best[i])
                self.slot_pos[i] += 1
        self._retire()
        return len(active)

    def run(self, max_ticks: int = 256) -> int:
        """Tick until every request is done (or ``max_ticks``); returns the
        number of ticks."""
        ticks = 0
        while (self.queue or any(self.slots)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks
