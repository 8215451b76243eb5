"""Sentence-encoder STUB (the port's copy of ``repro.data.encoder``; its
output must match the reference bit for bit).

The paper uses frozen pretrained encoders (all-mpnet-base-v2 etc.) purely as
a fixed featurizer Enc(s) → R^d. Offline we replace it with a deterministic
hashed bag-of-ngrams random projection: semantically similar strings (shared
tokens) land near each other, and the map is stable across processes —
which is all the routing stack requires of Enc(·).
"""
from __future__ import annotations

import hashlib

import numpy as np

_BUCKETS = 4096


def _tokens(text: str):
    toks = text.lower().split()
    return toks + [" ".join(p) for p in zip(toks, toks[1:])]  # uni+bi-grams


def _bucket(tok: str) -> int:
    return int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "little") % _BUCKETS


def _projection(d_emb: int) -> np.ndarray:
    rng = np.random.default_rng(1234)  # fixed: Enc is frozen
    return rng.standard_normal((_BUCKETS, d_emb)).astype(np.float32) / np.sqrt(d_emb)


def encode(texts, d_emb: int = 64) -> np.ndarray:
    """texts: list[str] → (len(texts), d_emb) float32, unit-normalized."""
    proj = _projection(d_emb)
    out = np.zeros((len(texts), d_emb), np.float32)
    for i, t in enumerate(texts):
        counts = np.zeros(_BUCKETS, np.float32)
        for tok in _tokens(t):
            counts[_bucket(tok)] += 1.0
        v = counts @ proj
        n = np.linalg.norm(v)
        out[i] = v / n if n > 0 else v
    return out
