"""Deterministic, shardable synthetic token pipeline.

Production framing: each (host, data-shard) pulls only ITS slice of the
global batch — `global_batch(step)` is pure in (step, seed), so any worker
can (re)materialize any step's data after restart or membership change
(deterministic data re-sharding is the fault-tolerance primitive).

The synthetic stream is a Zipf-ish unigram mix with short-range repetition
structure (so a small LM's loss actually decreases — used by the examples
and integration tests).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    repeat_prob: float = 0.35     # next-token = earlier token (structure)
    zipf_a: float = 1.2


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf-ish unigram distribution, deterministic in seed
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()
        self._perm = rng.permutation(cfg.vocab_size)

    def _gen(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        c = self.cfg
        toks = rng.choice(c.vocab_size, size=(batch, c.seq_len + 1),
                          p=self._probs)
        # structured repetition: with prob repeat_prob, copy a recent token
        rep = rng.random((batch, c.seq_len + 1)) < c.repeat_prob
        back = rng.integers(1, 8, size=(batch, c.seq_len + 1))
        idx = np.maximum(np.arange(c.seq_len + 1)[None, :] - back, 0)
        toks = np.where(rep, np.take_along_axis(toks, idx, axis=1), toks)
        return self._perm[toks].astype(np.int32)

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step) — restart-safe."""
        rng = np.random.default_rng((self.cfg.seed, step))
        toks = self._gen(rng, self.cfg.global_batch)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def shard_batch(self, step: int, shard: int, num_shards: int
                    ) -> Dict[str, np.ndarray]:
        """This worker's slice of the step's global batch. Changing
        num_shards (elastic resize) re-slices the SAME global stream."""
        assert self.cfg.global_batch % num_shards == 0
        per = self.cfg.global_batch // num_shards
        full = self.global_batch(step)
        sl = slice(shard * per, (shard + 1) * per)
        return {k: v[sl] for k, v in full.items()}

    def iter_batches(self, start_step: int = 0, shard: int = 0,
                     num_shards: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.shard_batch(step, shard, num_shards)
            step += 1
