"""Deterministic, shardable, resumable synthetic-token data pipeline —
a copy of ``repro.data.pipeline`` (numpy only), so the port's batches
equal the reference's bit for bit.

Production shape without external datasets: an order-preserving counter
-> splitmix64 -> token stream.  Every batch is a pure function of
(seed, step, shard), so:

  * resume: restart at step k reproduces exactly the batches an
    uninterrupted run would have seen;
  * data parallelism: each DP shard draws a disjoint slice;
  * elastic: changing the shard count re-partitions the same global
    stream (global batch content is invariant to the shard layout).

A light Zipf-ish transform gives the stream LM-like unigram statistics
so losses are non-degenerate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

__all__ = ["DataConfig", "DataIterator", "_splitmix64", "global_batch_at",
           "shard_batch_at"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _tokens_for(cfg: DataConfig, flat_index: np.ndarray) -> np.ndarray:
    """Map global (sample, position) counters to tokens."""
    h = _splitmix64(flat_index.astype(np.uint64)
                    + np.uint64(cfg.seed) * np.uint64(0x2545F4914F6CDD1D))
    u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    # inverse-CDF of a truncated zipf-like distribution
    v = cfg.vocab_size
    ranks = np.floor(v ** (u ** cfg.zipf_alpha)).astype(np.int64) - 1
    return np.clip(ranks, 0, v - 1).astype(np.int32)


def global_batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The full global batch for a step."""
    b, s = cfg.global_batch, cfg.seq_len
    sample = np.arange(b, dtype=np.uint64)[:, None] \
        + np.uint64(step) * np.uint64(b)
    posn = np.arange(s + 1, dtype=np.uint64)[None, :]
    idx = sample * np.uint64(s + 1) + posn
    toks = _tokens_for(cfg, idx)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def shard_batch_at(cfg: DataConfig, step: int, shard: int,
                   n_shards: int) -> Dict[str, np.ndarray]:
    """This DP shard's slice of the global batch (contiguous split)."""
    if cfg.global_batch % n_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {n_shards} shards")
    per = cfg.global_batch // n_shards
    g = global_batch_at(cfg, step)
    sl = slice(shard * per, (shard + 1) * per)
    return {k: v[sl] for k, v in g.items()}


class DataIterator:
    """Stateful iterator with a checkpointable cursor."""

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1,
                 start_step: int = 0):
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.step = start_step

    def __iter__(self) -> "DataIterator":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = shard_batch_at(self.cfg, self.step, self.shard,
                               self.n_shards)
        self.step += 1
        return batch

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "shard": self.shard,
                "n_shards": self.n_shards}

    @classmethod
    def from_state(cls, cfg: DataConfig, state: Dict[str, int],
                   shard: int, n_shards: int) -> "DataIterator":
        """Elastic resume: the saved step is layout-independent."""
        return cls(cfg, shard=shard, n_shards=n_shards,
                   start_step=int(state["step"]))
