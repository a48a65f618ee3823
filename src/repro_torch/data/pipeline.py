"""Deterministic, sharded, checkpointable token pipeline (a copy of
``repro.data.pipeline``: numpy only, so the port keeps its own).

The batch for global step s is a *pure function* of (seed, s, host shard) --
a stateless index->example map -- so restarts replay exactly from a saved
cursor (no iterator state beyond the step counter), preemption-safe by
construction.  Two sources:

  synthetic  -- Zipf-distributed token stream with a repeating-ngram
                structure (so small LMs show learnable signal)
  memmap     -- flat binary token file (np.memmap), documents drawn
                deterministically by step

Each host reads only its `process_index` slice of the global batch.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 128
    global_batch: int = 8
    vocab_size: int = 256
    seed: int = 0
    source: str = "synthetic"          # "synthetic" | path to token file
    zipf_a: float = 1.2
    ngram_repeat: int = 8              # structure scale for synthetic


class TokenPipeline:
    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1):
        assert cfg.global_batch % process_count == 0
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = cfg.global_batch // process_count
        self._step = 0
        self._mm = None
        if cfg.source != "synthetic":
            path = pathlib.Path(cfg.source)
            self._mm = np.memmap(path, dtype=np.int32, mode="r")

    # -- stateless map ------------------------------------------------------

    def batch_at(self, step: int) -> np.ndarray:
        """(local_batch, seq_len+1) int32 tokens for global step ``step``."""
        cfg = self.cfg
        rows = []
        for b in range(self.local_batch):
            gidx = (step * cfg.global_batch
                    + self.process_index * self.local_batch + b)
            rows.append(self._example(gidx))
        return np.stack(rows)

    def _example(self, gidx: int) -> np.ndarray:
        cfg = self.cfg
        n = cfg.seq_len + 1
        if self._mm is not None:
            start = (gidx * n) % max(1, len(self._mm) - n)
            return np.asarray(self._mm[start:start + n], np.int32)
        rng = np.random.Generator(np.random.Philox(key=cfg.seed + 1,
                                                   counter=gidx))
        # zipf-distributed unigrams with periodic ngram echo -> learnable
        base = rng.zipf(cfg.zipf_a, size=n).astype(np.int64)
        base = (base - 1) % cfg.vocab_size
        k = cfg.ngram_repeat
        if k > 1:
            echo = np.tile(base[:k], n // k + 1)[:n]
            mask = rng.random(n) < 0.5
            base = np.where(mask, echo, base)
        return base.astype(np.int32)

    # -- iterator protocol with explicit cursor -----------------------------

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        batch = self.batch_at(self._step)
        self._step += 1
        return batch

    def state(self) -> Dict:
        return {"step": self._step}

    def restore(self, state: Dict) -> None:
        self._step = int(state["step"])
