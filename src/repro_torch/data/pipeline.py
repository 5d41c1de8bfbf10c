"""Deterministic synthetic data pipeline with host-sharded loading, prefetch and
elastic re-sharding.

Tokens are generated from a seeded per-shard PRNG stream (a Zipf-ish unigram mix so
losses are non-trivial), keyed by (epoch, step, shard) — any host can regenerate any
shard, which is what makes failover/elastic re-sharding trivial: after a fleet
change the new shard count just re-partitions the same global stream.

The port's copy of ``repro/data/pipeline.py`` (numpy and threads only): the
same batches, byte for byte."""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    media_shape: tuple | None = None   # (M, D) stub frontend embeddings
    media_dtype: str = "float32"


class SyntheticStream:
    """Stateless shard generator: batch(step, shard_idx, n_shards)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rs = np.random.RandomState(cfg.seed)
        # fixed unigram distribution (Zipf-ish) + per-sequence markov-ish repeats
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        self.probs = (probs / probs.sum()).astype(np.float64)

    def batch(self, step: int, shard: int, n_shards: int) -> dict:
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0, (cfg.global_batch, n_shards)
        b_local = cfg.global_batch // n_shards
        rs = np.random.RandomState(
            ((cfg.seed * 1_000_003 + step) * 4096 + shard * 17 + 11) % (2 ** 32))
        toks = rs.choice(cfg.vocab_size, size=(b_local, cfg.seq_len),
                         p=self.probs).astype(np.int32)
        # inject local structure: repeat previous token with prob .25
        rep = rs.rand(b_local, cfg.seq_len) < 0.25
        for i in range(1, cfg.seq_len):
            toks[:, i] = np.where(rep[:, i], toks[:, i - 1], toks[:, i])
        out = {"tokens": toks}
        if cfg.media_shape is not None:
            M, D = cfg.media_shape
            out["media"] = rs.randn(b_local, M, D).astype(cfg.media_dtype) * 0.02
        return out


class Prefetcher:
    """Background-thread prefetch of the next `depth` host batches."""

    def __init__(self, stream: SyntheticStream, shard: int, n_shards: int,
                 depth: int = 2, start_step: int = 0):
        self.stream = stream
        self.shard, self.n_shards = shard, n_shards
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            b = self.stream.batch(self._step, self.shard, self.n_shards)
            self.q.put((self._step, b))
            self._step += 1

    def next(self):
        return self.q.get()

    def stop(self):
        self._stop = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
