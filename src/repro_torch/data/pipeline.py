"""Deterministic synthetic LM data pipeline (port of ``repro.data.pipeline``).

Numpy only, the reference's code: batches are bitwise the reference's for
the same ``(seed, step, host_id)``. An infinite stream of ``(tokens,
labels)`` batches from a counter-seeded PRNG, deterministic given ``(seed,
step)``, so a restarted job resumes mid-epoch bit-identically (the
checkpoint stores only the step). Structure is injected so the LM loss
actually decreases: a first-order Markov chain over the vocab with a few
high-probability successor patterns.

For multi-host training each host draws only its shard of the global batch
(``host_id``/``num_hosts``); one process is host 0 of 1.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["SyntheticLMConfig", "SyntheticLM", "batches"]


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    markov_branch: int = 4  # successors per token (lower = easier)


class SyntheticLM:
    """Counter-based synthetic corpus: batch(step) is a pure function."""

    def __init__(self, cfg: SyntheticLMConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.local_batch = cfg.global_batch // cfg.num_hosts
        # Fixed Markov successor table (the learnable structure).
        rng = np.random.default_rng(cfg.seed)
        self.successors = rng.integers(
            0, cfg.vocab_size, size=(cfg.vocab_size, cfg.markov_branch)
        ).astype(np.int32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id)
        )
        b, s = self.local_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        choices = rng.integers(0, cfg.markov_branch, size=(b, s))
        # 10% random restarts keep entropy positive.
        restart = rng.random((b, s)) < 0.1
        random_tok = rng.integers(0, cfg.vocab_size, size=(b, s))
        for t in range(s):
            nxt = self.successors[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(restart[:, t], random_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterator(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def batches(
    vocab_size: int,
    seq_len: int,
    global_batch: int,
    *,
    seed: int = 0,
    start_step: int = 0,
) -> Iterator[dict[str, np.ndarray]]:
    ds = SyntheticLM(
        SyntheticLMConfig(vocab_size, seq_len, global_batch, seed=seed)
    )
    return ds.iterator(start_step)
