"""Deterministic, shard-aware, resumable synthetic data pipeline (the
port's own copy of ``repro/data/pipeline.py``, numpy only: the same
batches for the same ``(seed, step)``).

Every batch is a pure function of (seed, step): any host can materialize
its shard independently (no coordinator), and resume-from-checkpoint is
exact by construction — the iterator state IS the step counter.

Two stream kinds:
  * ``uniform``  — i.i.d. tokens (throughput/dry-run work);
  * ``bigram``   — sampled from a fixed random bigram table, a learnable
    distribution for convergence experiments (the CIFAR/IMDb stand-in on
    this offline container; see DESIGN.md §6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


KINDS = ("bigram", "uniform")


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "bigram"            # bigram | uniform
    bigram_temp: float = 0.5


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.kind not in KINDS:
            raise ValueError(f"data kind {cfg.kind!r} not in {KINDS}")
        if cfg.kind == "bigram":
            rng = np.random.Generator(np.random.Philox(key=cfg.seed))
            logits = rng.normal(size=(cfg.vocab_size, cfg.vocab_size))
            logits = logits / cfg.bigram_temp
            p = np.exp(logits - logits.max(-1, keepdims=True))
            self._P = (p / p.sum(-1, keepdims=True)).astype(np.float64)
            self._cum = np.cumsum(self._P, axis=-1)

    # ------------------------------------------------------------------
    def batch_at(self, step: int, *, shard: int = 0, num_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        """Batch (or one data shard of it) for a given step."""
        cfg = self.cfg
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {num_shards} shards")
        bs = cfg.global_batch // num_shards
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed + 1, counter=(step * num_shards + shard)))
        if cfg.kind == "uniform":
            toks = rng.integers(0, cfg.vocab_size,
                                size=(bs, cfg.seq_len + 1), dtype=np.int64)
        else:
            toks = np.empty((bs, cfg.seq_len + 1), np.int64)
            toks[:, 0] = rng.integers(0, cfg.vocab_size, size=bs)
            u = rng.random(size=(bs, cfg.seq_len))
            for t in range(cfg.seq_len):
                # inverse-CDF sampling from the bigram row of each prefix
                rows = self._cum[toks[:, t]]
                toks[:, t + 1] = (u[:, t, None] < rows).argmax(-1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def optimal_loss(self) -> float:
        """Entropy rate of the bigram chain (the achievable loss floor)."""
        if self.cfg.kind != "bigram":
            return float(np.log(self.cfg.vocab_size))
        P = self._P
        # stationary distribution via power iteration
        pi = np.full(P.shape[0], 1.0 / P.shape[0])
        for _ in range(200):
            pi = pi @ P
        H = -(pi[:, None] * P * np.log(np.maximum(P, 1e-12))).sum()
        return float(H)


def make_iterator(data: SyntheticLM, start_step: int = 0, *, shard: int = 0,
                  num_shards: int = 1):
    step = start_step
    while True:
        yield step, data.batch_at(step, shard=shard, num_shards=num_shards)
        step += 1
