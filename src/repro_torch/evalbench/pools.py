"""Many-model pool construction for RouterBench-style evaluation
(PyTorch counterpart of ``repro/evalbench/pools.py``).

With only a handful of models, a degenerate "always pick the big one"
policy looks like routing. ``make_pool_corpus`` builds corpora whose pool
is wide enough (default 16 > RouterBench's 11) that the frontier has many
non-dominated price points, and ``pool_table`` summarizes the pool the
way RouterBench's model table does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.synthetic import make_eval_corpus
from repro_torch.device import DeviceLike, generator, resolve_device


def make_pool_corpus(gen, *, n_models: int = 16, n_queries: int = 4000,
                     n_tasks: int = 8, d_emb: int = 64,
                     device: DeviceLike = None, **kw) -> dict:
    """A synthetic evaluation corpus with a many-model pool, drawn from
    ``gen`` (a generator on the target device or an int seed) on the CUDA
    device unless ``device`` names another. Extra keywords forward to
    ``data.synthetic.make_eval_corpus``."""
    gen = generator(gen, resolve_device(device))
    return make_eval_corpus(gen, n_queries=n_queries, n_tasks=n_tasks,
                            n_models=n_models, d_emb=d_emb, **kw)


def as_f64(a) -> np.ndarray:
    """A tensor or array as a float64 numpy array (on the host)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def pool_table(corpus: dict) -> list:
    """Per-model pool summary: [{"model", "mean_acc", "mean_cost",
    "wins"}] where "wins" counts the queries the model tops on true
    accuracy — a pool is routing-worthy iff wins spread over many models."""
    acc = as_f64(corpus["acc_table"])
    cost = as_f64(corpus["cost_table"])
    winners = acc.argmax(axis=1)
    return [{
        "model": m,
        "mean_acc": float(acc[:, m].mean()),
        "mean_cost": float(cost[:, m].mean()),
        "wins": int((winners == m).sum()),
    } for m in range(acc.shape[1])]
