"""Deterministic synthetic token pipeline (checkpointable, shardable); the
port's copy of ``repro.data.tokens``, pure numpy.

A Zipf-ish unigram stream with planted bigram structure so models show a
clearly decreasing loss (learnable signal) without shipping a corpus.
State = (seed, step): restart-exact after checkpoint restore. Each host
slices its data-parallel shard by process index (single process here).
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0,
                 step: int = 0, process_index: int = 0, process_count: int = 1):
        self.vocab, self.batch, self.seq_len = vocab, batch, seq_len
        self.seed, self.step = seed, step
        self.process_index, self.process_count = process_index, process_count
        # planted bigram table: token t prefers (t*a+c) % V
        self.a = 31, 17

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, vocab, batch, seq_len, state, **kw):
        return cls(vocab, batch, seq_len, seed=state["seed"],
                   step=state["step"], **kw)

    def __next__(self):
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.step) * self.process_count
            + self.process_index
        )
        b = self.batch // self.process_count
        # zipf-ish marginals
        ranks = np.arange(1, self.vocab + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = np.empty((b, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.choice(self.vocab, size=b, p=probs)
        noise = rng.random((b, self.seq_len))
        fresh = rng.choice(self.vocab, size=(b, self.seq_len), p=probs)
        a, c = self.a
        for t in range(1, self.seq_len + 1):
            follow = (toks[:, t - 1] * a + c) % self.vocab
            toks[:, t] = np.where(noise[:, t - 1] < 0.7, follow, fresh[:, t - 1])
        self.step += 1
        return {"tokens": toks}

    def __iter__(self):
        return self
