"""Token-stream batches for the transformer training driver, the port's own
copy of ``repro.data.pipeline``: the same numpy ``default_rng`` draws, so
its batches are ``repro``'s bit for bit."""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    """Infinite iterator of next-token-prediction batches ``[B, S+1]``
    (numpy; the caller moves them to its device)."""

    def __init__(self, corpus: np.ndarray, batch: int, seq_len: int,
                 seed: int = 0):
        if corpus.ndim != 2 or corpus.shape[1] < seq_len + 1:
            raise ValueError(f"corpus {corpus.shape} holds no rows of "
                             f"seq_len + 1 = {seq_len + 1} tokens")
        self.corpus = corpus
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        rows = self.rng.integers(0, len(self.corpus), self.batch)
        starts = self.rng.integers(
            0, self.corpus.shape[1] - self.seq_len, self.batch)
        return np.stack([self.corpus[r, s:s + self.seq_len + 1]
                         for r, s in zip(rows, starts)])
