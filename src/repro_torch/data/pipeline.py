"""Deterministic synthetic data pipeline with sharded host loading.

A copy of the JAX package's ``data/pipeline.py``, which is numpy-only: the
batch at step s is a pure function of ``(seed, s, host_index)``, so the
port's stream is byte-identical to the reference's.  Synthetic token
streams (nothing is downloaded), but the machinery is the real thing:
per-host sharding (each host materialises only its slice), double-buffered
prefetch, and O(1) ``skip_to`` for exact checkpoint resume.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ArchConfig

__all__ = ["SyntheticDataset", "Prefetcher"]


@dataclasses.dataclass
class SyntheticDataset:
    """Deterministic LM batches: batch at step s is a pure function of
    (seed, s) — restart at any step reproduces the exact stream."""

    cfg: ArchConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    # host slice (multi-host data loading: each host loads its rows only)
    host_index: int = 0
    host_count: int = 1
    step: int = 0
    token_range: int = 0  # >0: draw tokens from [0, token_range) (learnable)

    def __post_init__(self):
        assert self.global_batch % self.host_count == 0
        self.local_batch = self.global_batch // self.host_count

    def skip_to(self, step: int) -> "SyntheticDataset":
        self.step = step
        return self

    def _batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step, self.host_index))
        b, s = self.local_batch, self.seq_len
        cfg = self.cfg
        hi = self.token_range or cfg.vocab
        out: Dict[str, np.ndarray] = {}
        if cfg.family == "vlm":
            out["tokens"] = rng.integers(0, hi, (b, s - cfg.patch_tokens), dtype=np.int32)
            out["patches"] = rng.normal(0, 0.02, (b, cfg.patch_tokens, cfg.d_model)).astype(
                np.float32
            )
        elif cfg.family == "encdec":
            out["tokens"] = rng.integers(0, hi, (b, s), dtype=np.int32)
            out["frames"] = rng.normal(0, 0.02, (b, min(s, cfg.enc_frames), cfg.d_model)).astype(
                np.float32
            )
        else:
            out["tokens"] = rng.integers(0, hi, (b, s), dtype=np.int32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self._batch(self.step)
            self.step += 1


class Prefetcher:
    """Background-thread double buffering (host -> device overlap)."""

    def __init__(self, it: Iterator, depth: int = 2, device_put=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._put = device_put or (lambda x: x)
        self._stop = False

        def worker():
            for item in it:
                if self._stop:
                    return
                self._q.put(self._put(item))

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop = True
