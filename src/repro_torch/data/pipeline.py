"""Deterministic synthetic data pipelines.

The port's own copy of ``repro.data.pipeline``: a batch is generated
with numpy from (seed, step, shard), so both packages draw bitwise-equal
batches, and a restarted run replays the stream exactly. ``SyntheticLM``
is a first-order Markov token stream (a fixed random transition table,
so the next-token entropy is well below uniform and a model's loss falls
fast); ``SyntheticImages`` makes class-conditional blob images for the
spiking classifiers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str                  # 'lm' | 'images'
    global_batch: int
    seq_len: int = 0
    vocab_size: int = 0
    img_size: int = 32
    channels: int = 3
    num_classes: int = 10
    seed: int = 1234
    shard_index: int = 0
    num_shards: int = 1

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.num_shards == 0
        return self.global_batch // self.num_shards


class SyntheticLM:
    """First-order Markov chain over a hashed transition table."""

    def __init__(self, cfg: DataConfig, branching: int = 8):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self.next_tokens = rng.integers(0, v, size=(v, branching),
                                        dtype=np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, cfg.shard_index))
        b, s = cfg.local_batch, cfg.seq_len
        toks = np.empty((b, s), dtype=np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        branch = rng.integers(0, self.next_tokens.shape[1], size=(b, s))
        for t in range(1, s):
            toks[:, t] = self.next_tokens[toks[:, t - 1], branch[:, t]]
        return {"tokens": toks}


class SyntheticImages:
    """Class-conditional Gaussian-blob images + labels."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n, c = cfg.num_classes, cfg.channels
        self.prototypes = rng.uniform(
            0.2, 0.8, size=(n, cfg.img_size, cfg.img_size, c)).astype(
                np.float32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, cfg.shard_index))
        b = cfg.local_batch
        labels = rng.integers(0, cfg.num_classes, size=b)
        noise = rng.normal(0, 0.15, size=(b, cfg.img_size, cfg.img_size,
                                          cfg.channels)).astype(np.float32)
        images = np.clip(self.prototypes[labels] + noise, 0.0, 1.0)
        return {"images": images, "labels": labels.astype(np.int32)}


def make_pipeline(cfg: DataConfig):
    if cfg.kind == "lm":
        return SyntheticLM(cfg)
    if cfg.kind == "images":
        return SyntheticImages(cfg)
    raise ValueError(cfg.kind)
