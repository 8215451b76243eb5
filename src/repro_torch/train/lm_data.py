"""Synthetic LM token pipeline for end-to-end training (PyTorch port's
copy of ``repro/train/lm_data.py``).

A Markov chain over latent states, each emitting a skewed distribution
over a vocab slice: the model has real statistical signal to learn (the
loss falls measurably within a few hundred steps on a ~100M model),
unlike iid-uniform tokens. Batches are (tokens, labels) with next-token
alignment, as numpy int32 arrays. The draws are numpy ``default_rng``
draws in the reference's order, so one seed gives the reference's
batches bit for bit.
"""
from __future__ import annotations

import numpy as np


class MarkovLM:
    def __init__(self, vocab: int, order_states: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.n_states = order_states
        # sparse-ish row-stochastic transition over latent states
        logits = rng.standard_normal((order_states, order_states)) * 2.0
        self.trans = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        # each latent state emits a skewed distribution over a vocab slice
        emit = rng.standard_normal((order_states, vocab)) * 2.5
        self.emit = np.exp(emit) / np.exp(emit).sum(1, keepdims=True)
        self.emit_cdf = np.cumsum(self.emit, axis=1)
        self.trans_cdf = np.cumsum(self.trans, axis=1)
        self.rng = rng

    def sample(self, batch: int, seq: int) -> np.ndarray:
        """Vectorized inverse-CDF sampling of the latent-state chain."""
        s = self.rng.integers(0, self.n_states, size=batch)
        out = np.zeros((batch, seq + 1), np.int32)
        for t in range(seq + 1):
            u = self.rng.random((batch, 1))
            out[:, t] = (self.emit_cdf[s] < u).sum(axis=1)
            u2 = self.rng.random((batch, 1))
            s = (self.trans_cdf[s] < u2).sum(axis=1)
        return np.clip(out, 0, self.vocab - 1)

    def batches(self, batch: int, seq: int):
        while True:
            toks = self.sample(batch, seq)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
