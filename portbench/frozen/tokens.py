"""Token rows with the statistics of the port's ``data/tokens.TokenStream``
(a copy of its draw): Zipf-like unigrams with a planted bigram, so a prompt
is not white noise."""
from __future__ import annotations

import numpy as np


def token_rows(vocab: int, rows: int, length: int, seed) -> np.ndarray:
    """(rows, length) int32 tokens in [1, vocab): 0 is the engine's pad."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab)
    probs /= probs.sum()
    toks = np.empty((rows, length), np.int64)
    toks[:, 0] = 1 + rng.choice(vocab - 1, size=rows, p=probs)
    noise = rng.random((rows, length))
    fresh = 1 + rng.choice(vocab - 1, size=(rows, length), p=probs)
    a, c = 31, 17
    for t in range(1, length):
        follow = 1 + (toks[:, t - 1] * a + c) % (vocab - 1)
        toks[:, t] = np.where(noise[:, t - 1] < 0.7, follow, fresh[:, t - 1])
    return toks.astype(np.int32)
