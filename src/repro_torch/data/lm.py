"""Deterministic synthetic LM token stream: a copy of
``repro/data/lm.py`` (numpy only), so the same seed and step give the
reference's batches bit for bit.

Stateless: ``batch_at(step)`` derives every batch from (seed, step) alone,
so checkpoint-restart resumes the exact data order with no sampler state to
save (DESIGN.md §4 fault tolerance).  The stream is a mixture of Zipfian
unigrams and short repeated motifs so the loss has learnable structure.
"""
from __future__ import annotations

import numpy as np

__all__ = ["LMStream"]


class LMStream:
    def __init__(self, vocab: int, seq: int, batch: int, seed: int = 0,
                 motif_len: int = 8, n_motifs: int = 256):
        self.vocab, self.seq, self.batch, self.seed = vocab, seq, batch, seed
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.unigram = (ranks ** -1.1) / (ranks ** -1.1).sum()
        self.motifs = rng.integers(0, vocab,
                                   size=(n_motifs, motif_len)).astype(np.int32)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(self.vocab, p=self.unigram,
                          size=(self.batch, self.seq + 1)).astype(np.int32)
        # splice motifs for structure
        n_splice = self.seq // 16
        for b in range(self.batch):
            ids = rng.integers(0, self.motifs.shape[0], size=n_splice)
            pos = rng.integers(0, self.seq - self.motifs.shape[1],
                               size=n_splice)
            for m, p in zip(ids, pos):
                toks[b, p : p + self.motifs.shape[1]] = self.motifs[m]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
