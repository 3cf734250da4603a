"""Synthetic token pipeline: deterministic, sharded, prefetching. The
port's copy of ``repro.data.tokens`` (numpy and a prefetch thread; no JAX):
the same ``(seed, host, step)`` gives the same batch in both packages.

Each host draws only ITS batch shard (host_id-keyed PRNG); the cursor
(`step`) lives in checkpoints for exact resume. A background prefetch
thread keeps `depth` batches ready; ``close`` stops it.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class TokenPipeline:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        batch_per_host: int,
        seed: int = 0,
        host_id: int = 0,
        prefix_len: int = 0,
        d_model: int = 0,
        start_step: int = 0,
        prefetch_depth: int = 2,
    ):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_per_host
        self.seed = seed
        self.host = host_id
        self.prefix_len = prefix_len
        self.d_model = d_model
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.host, step))
        tok_len = self.seq - self.prefix_len
        batch = {
            "tokens": rng.integers(0, self.vocab, (self.batch, tok_len), dtype=np.int32)
        }
        if self.prefix_len:
            batch["prefix_embeds"] = rng.standard_normal(
                (self.batch, self.prefix_len, self.d_model), dtype=np.float32
            )
        return batch

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put(self._make(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._q.get()
        self.step += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def cursor(self) -> int:
        return self.step

    def close(self):
        self._stop.set()
