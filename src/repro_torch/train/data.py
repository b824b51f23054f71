"""Deterministic, seekable synthetic token pipeline.

Every batch is a pure function of (seed, step), so a restarted job
resumes mid-epoch exactly (no data-order drift after preemption) and any
worker can regenerate any shard — the property a 1000-node input pipeline
needs.  A Zipf-ish unigram mixture with injected n-gram structure gives a
loss surface a 100M model can actually descend.

A copy of the reference package's ``repro.train.data`` (numpy only): the
same ``(seed, step)`` gives the same arrays in both packages.
"""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, ngram: int = 3):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.ngram = ngram
        rng = np.random.default_rng(seed)
        # fixed "language": transition tables biasing next-token choices
        self._uni = (1.0 / (np.arange(vocab_size) + 10.0))
        self._uni /= self._uni.sum()
        self._shift = rng.integers(1, vocab_size, size=vocab_size)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        x = np.empty((self.batch, self.seq + 1), np.int32)
        x[:, 0] = rng.choice(self.vocab, size=self.batch, p=self._uni)
        noise = rng.random((self.batch, self.seq))
        fresh = rng.choice(self.vocab, size=(self.batch, self.seq),
                           p=self._uni)
        for t in range(1, self.seq + 1):
            follow = self._shift[x[:, t - 1]] % self.vocab
            x[:, t] = np.where(noise[:, t - 1] < 0.75, follow,
                               fresh[:, t - 1])
        return {"inputs": x[:, :-1], "labels": x[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
