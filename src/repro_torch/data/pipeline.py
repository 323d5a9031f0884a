"""Deterministic synthetic data pipeline with host sharding and
checkpointable state (the port of ``repro.data.pipeline``: numpy only,
its batches bit-equal to the reference's).

A "corpus" of documents is generated on the fly from a counter-based hash
(SplitMix64) — the same (seed, doc_id, position) always yields the same
token, so any host can materialize any slice without storage, restarts are
exactly reproducible, and hosts shard by document id.  Documents follow a
power-lawish length distribution and are packed into fixed-length training
rows with an EOS separator (packing like real LM pipelines; cross-document
attention masking is intentionally not applied, matching common practice).

The pipeline state is a single integer cursor -> trivially checkpointable.
A background prefetch thread keeps ``depth`` batches ready; it holds a
batch it could not queue and offers it again, so the consumer sees the
pipeline's batches in order (the reference's thread drops such a batch
when the queue stays full for its 0.2 s timeout).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

EOS = 0


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    num_hosts: int = 1
    host_id: int = 0


class SyntheticCorpus:
    """Deterministic documents: tokens = hash(seed, doc, pos) % (vocab-1)+1."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def doc_length(self, doc_id: int) -> int:
        h = _splitmix64(np.uint64(self.cfg.seed * 1_000_003 + doc_id))
        # 16..4*mean, skewed short
        u = (int(h) % 10_000) / 10_000.0
        return int(16 + (u ** 2) * 4 * self.cfg.mean_doc_len)

    def doc_tokens(self, doc_id: int) -> np.ndarray:
        n = self.doc_length(doc_id)
        idx = np.arange(n, dtype=np.uint64)
        h = _splitmix64(
            np.uint64(self.cfg.seed) * np.uint64(0x9E37)
            + np.uint64(doc_id) * np.uint64(1 << 20) + idx)
        return (h % np.uint64(self.cfg.vocab - 1)).astype(np.int32) + 1


class TokenPipeline:
    """Packs corpus documents into (local_batch, seq_len+1) rows.

    Host h consumes documents h, h+H, h+2H, ... (disjoint shards); the
    cursor state is (next_doc, leftover tokens) and round-trips through
    ``state()`` / ``restore()`` for checkpointing.
    """

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg)
        self.local_batch = cfg.global_batch // cfg.num_hosts
        self._next_doc = cfg.host_id
        self._buffer = np.zeros((0,), np.int32)

    # -- checkpointable state ------------------------------------------------
    def state(self) -> dict:
        return {"next_doc": int(self._next_doc),
                "buffer": self._buffer.tolist()}

    def restore(self, state: dict) -> None:
        self._next_doc = int(state["next_doc"])
        self._buffer = np.asarray(state["buffer"], np.int32)

    # -- iteration -------------------------------------------------------------
    def _fill(self, n_tokens: int) -> np.ndarray:
        parts = [self._buffer]
        total = self._buffer.size
        while total < n_tokens:
            doc = self.corpus.doc_tokens(self._next_doc)
            self._next_doc += self.cfg.num_hosts
            parts.append(doc)
            parts.append(np.array([EOS], np.int32))
            total += doc.size + 1
        flat = np.concatenate(parts)
        self._buffer = flat[n_tokens:]
        return flat[:n_tokens]

    def next_batch(self) -> dict[str, np.ndarray]:
        need = self.local_batch * (self.cfg.seq_len + 1)
        flat = self._fill(need)
        rows = flat.reshape(self.local_batch, self.cfg.seq_len + 1)
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


class _Prefetcher:
    def __init__(self, pipeline: TokenPipeline, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.pipeline = pipeline
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        batch = None
        while not self._stop.is_set():
            if batch is None:
                batch = self.pipeline.next_batch()
            try:
                self.q.put(batch, timeout=0.2)
            except queue.Full:
                continue
            batch = None

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()


def make_pipeline(cfg: DataConfig, prefetch: int = 0):
    p = TokenPipeline(cfg)
    if prefetch:
        return _Prefetcher(p, depth=prefetch)
    return p
