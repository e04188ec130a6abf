"""Deterministic synthetic data pipeline.

Port of `repro/data/pipeline.py`, which is numpy only: `DataConfig`,
`SyntheticLM` and `PrefetchingLoader` are kept as they are, so a batch is
bitwise the reference's for the same (seed, step, host). The trainer turns
the numpy arrays into tensors on its device.

Every batch is a pure function of (step, host shard): `batch(step)` needs no
iterator state, so any restarted, elastic or straggling host can jump to
step N without replay, and two hosts can never disagree about batch
contents. Tokens follow a Zipf-ish mixture with enough structure (copy
runs, local n-gram statistics) that a real LM's loss decreases measurably
within a few hundred steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    # this host's shard of the global batch (elastic: recompute on resize)
    host_index: int = 0
    n_hosts: int = 1
    seed: int = 1234


class SyntheticLM:
    """Stateless synthetic LM corpus: batch = f(step)."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global batch must divide by host count")
        self.cfg = cfg
        self.per_host = cfg.global_batch // cfg.n_hosts

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.uint64(cfg.seed) + np.uint64(step) * np.uint64(1_000_003)
            + np.uint64(cfg.host_index) * np.uint64(7_777_777))
        b, s = self.per_host, cfg.seq_len
        # Zipf-distributed base stream
        ranks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        tokens = ranks % cfg.vocab
        # inject copy runs so there is learnable structure (needs room)
        if s > 20:
            n_runs = max(1, s // 64)
            for i in range(b):
                for _ in range(n_runs):
                    start = rng.integers(0, s - 16)
                    length = int(rng.integers(4, 16))
                    src = rng.integers(0, max(1, s - length))
                    tokens[i, start:start + length] = tokens[i, src:src + length]
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "targets": tokens[:, 1:].astype(np.int32),
        }

    def reshard(self, host_index: int, n_hosts: int) -> "SyntheticLM":
        """Elastic resize: same corpus, new host partition."""
        return SyntheticLM(dataclasses.replace(
            self.cfg, host_index=host_index, n_hosts=n_hosts))


class PrefetchingLoader:
    """Host-side prefetch thread over a stateless source: overlaps batch
    synthesis with device execution."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2):
        import queue
        import threading
        self.source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put((step, source.batch(step)), timeout=0.2)
                    step += 1
                except Exception:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
