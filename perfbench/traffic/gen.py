"""The one traffic generator. A mix is a JSON file of parameters beside
this module (``<name>.json``); ``load(name)`` reads it and ``stream(mix,
seed, seconds, d_emb, vocab)`` draws a run's requests from it.

Two loops:

* ``"open"`` — independent users: requests are due on a schedule
  whatever the server does. ``warm_s`` seconds of warm traffic come before
  the window, ``rate_per_s`` × ``--seconds`` requests in it, their gaps
  drawn as ``arrivals`` says (``gaps``).
* ``"closed"`` — callers that each wait for a reply: ``backlog`` requests
  are outstanding and each completion submits the next. The stream is
  endless; request k is the k-th of it. The first ``warm_steps`` engine
  steps are warm traffic.

Every seed gets the same work in another order. The lengths, query
embeddings and λ of a set of requests are fixed by the mix alone: lengths
are stratified quantiles of the mix's clipped lognormals, paired and drawn
with its ``set_seed``. The run's seed orders the set, orders the
inter-arrival gaps (stratified quantiles, so the multiset of gaps is
fixed too) and draws the token ids. The window's set is one set of its own.
A closed loop repeats one block of ``block`` requests, each copy in its
own order, so any run of whole blocks holds the same requests; those
orders are the mix's (``set_seed``) and the same for every seed, which
draws only the token ids. In a closed loop the order decides which
requests share a step and so how many finish within a window that holds
less than a block: with the order drawn from the seed, the same work
read 10% apart between seeds.

Pure numpy: a function of (mix, seed, seconds) and nothing else.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from statistics import NormalDist
from typing import Optional

import numpy as np

DIR = Path(__file__).resolve().parent
LOOPS = ("open", "closed")


def load(name: str) -> dict:
    """The mix ``<name>.json`` beside this module."""
    mix = json.loads((DIR / f"{name}.json").read_text())
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"traffic {name}: loop must be one of {LOOPS}")
    return mix


def quantiles(dist: dict, n: int) -> np.ndarray:
    """n stratified quantiles (k + 0.5) / n of a lognormal with the given
    median and sigma, rounded and clipped to [min, max]."""
    q = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(v)) for v in q])
    x = np.exp(np.log(dist["median"]) + dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """n stratified quantiles of the exponential with mean 1 / rate."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def gaps(arrivals: dict, rate: float, n: int) -> np.ndarray:
    """n stratified inter-arrival gaps with mean 1 / rate: exponential
    (Poisson arrivals), or uniform on [(1 - spread), (1 + spread)] / rate
    (a steady stream of independent users, coefficient of variation
    spread / √3)."""
    if arrivals.get("dist", "exponential") == "exponential":
        return exp_gaps(rate, n)
    q = (np.arange(n) + 0.5) / n
    s = float(arrivals["spread"])
    return (1.0 - s + 2.0 * s * q) / rate


@dataclasses.dataclass
class RequestSet:
    """A fixed set of n requests: lengths, query embeddings, λ."""
    prompt_len: np.ndarray
    out_len: np.ndarray
    x: np.ndarray
    lam: np.ndarray

    def take(self, order: np.ndarray) -> "RequestSet":
        return RequestSet(self.prompt_len[order], self.out_len[order],
                          self.x[order], self.lam[order])


def request_set(mix: dict, n: int, d_emb: int, tag: int) -> RequestSet:
    """The mix's fixed set of n requests (``tag`` tells the warm set, the
    window's set and the closed loop's block apart)."""
    rng = np.random.default_rng([int(mix["set_seed"]), int(n), int(tag)])
    P = quantiles(mix["prompt"], n)
    O = quantiles(mix["output"], n)[rng.permutation(n)]
    x = rng.standard_normal((n, d_emb)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    lam = rng.uniform(mix["lam"]["min"], mix["lam"]["max"], n)
    return RequestSet(P, O, x, lam.astype(np.float32))


WARM, WINDOW, BLOCK = 1, 2, 3


@dataclasses.dataclass
class Stream:
    """A run's requests. Open loop: ``n`` requests, ``due`` seconds from
    the window's start (negative: warm traffic), in due order. Closed
    loop: ``n`` is None and ``item(k)`` gives the k-th request."""
    mix: dict
    seed: int
    vocab: int
    n: Optional[int]
    due: Optional[np.ndarray]
    reqs: Optional[RequestSet]
    block: Optional[RequestSet]

    def item(self, k: int) -> tuple:
        """(prompt_len, out_len, x, lam) of request k."""
        if self.reqs is not None:
            r, i = self.reqs, k
        else:
            B = len(self.block.prompt_len)
            b, j = divmod(k, B)
            order = np.random.default_rng(
                [int(self.mix["set_seed"]), 3, b]).permutation(B)
            r, i = self.block, int(order[j])
        return (int(r.prompt_len[i]), int(r.out_len[i]), r.x[i],
                float(r.lam[i]))

    def tokens(self, k: int) -> np.ndarray:
        """Request k's prompt token ids, uniform in [1, vocab)."""
        P = self.item(k)[0]
        return np.random.default_rng([self.seed, 7, k]).integers(
            1, self.vocab, P, dtype=np.int64).astype(np.int32)


def stream(mix: dict, seed: int, seconds: float, d_emb: int,
           vocab: int) -> Stream:
    """A run's requests (see the module doc). ``vocab``: token ids are
    drawn below it (the smallest vocabulary of the pool)."""
    seed = int(seed)
    if mix["loop"] == "closed":
        blk = request_set(mix, int(mix["block"]), d_emb, BLOCK)
        return Stream(mix, seed, vocab, None, None, None, blk)
    rate = float(mix["rate_per_s"])
    parts, dues = [], []
    for tag, span, start in ((WARM, float(mix["warm_s"]), None),
                             (WINDOW, float(seconds), 0.0)):
        n = int(round(rate * span))
        if n == 0:
            continue
        rng = np.random.default_rng([seed, tag])
        parts.append(request_set(mix, n, d_emb, tag).take(
            rng.permutation(n)))
        g = gaps(mix.get("arrivals", {}), rate, n)[rng.permutation(n)]
        t = np.concatenate([[0.0], np.cumsum(g)[:-1]])
        dues.append(t - span if start is None else t)
    reqs = RequestSet(*(np.concatenate([getattr(p, f.name) for p in parts])
                        for f in dataclasses.fields(RequestSet)))
    due = np.concatenate(dues)
    return Stream(mix, seed, vocab, len(due), due, reqs, None)
