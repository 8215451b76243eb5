"""Synthetic RouterBench-like query–model evaluation corpus (PyTorch
counterpart of ``repro/data/synthetic.py``).

The same statistical anatomy as the reference, drawn from a
``torch.Generator`` (so the numbers differ from the reference's for one
seed; tests check shapes and statistics, and parity tests feed the
reference's own corpus):

  * T task clusters in embedding space (RouterBench = 8 public datasets) —
    queries are noisy samples around task centroids;
  * M models with cost-correlated base quality plus per-task affinities —
    so no model dominates at every price point (RouterBench = 11 LLMs);
  * observed accuracy is a Bernoulli draw of the latent per-(query, model)
    success probability; observed cost is the latent cost + noise.

Ground-truth acc/cost tables for every (query, model) pair are kept for
test-time frontier scoring.
"""
from __future__ import annotations

import math

import torch


def make_eval_corpus(gen: torch.Generator, *, n_queries: int = 8000,
                     n_tasks: int = 8, n_models: int = 11, d_emb: int = 64,
                     cluster_noise: float = 0.45, sharpness: float = 3.0,
                     affinity: float = 0.35) -> dict:
    """The corpus as tensors on ``gen``'s device."""
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # task geometry: well-separated centroids on the unit sphere × radius
    mu = normal(n_tasks, d_emb)
    mu = 2.5 * mu / torch.linalg.norm(mu, dim=1, keepdim=True)
    task = torch.randint(0, n_tasks, (n_queries,), generator=gen, device=dev)
    x = mu[task] + cluster_noise * normal(n_queries, d_emb)

    # model economics: log-spaced price, quality correlated with price
    cost_base = torch.logspace(math.log10(0.02), 0.0, n_models, device=dev)
    quality = 0.15 + 0.55 * cost_base ** 0.3 + 0.08 * normal(n_models)
    task_affinity = affinity * normal(n_models, n_tasks)

    difficulty = 0.25 * normal(n_queries)
    logits = sharpness * (quality[None, :] + task_affinity[:, task].T
                          - 0.55 - difficulty[:, None])
    acc_table = torch.sigmoid(logits)                        # (Q, M)

    length_factor = 0.8 + 0.4 * torch.rand((n_queries,), generator=gen,
                                           device=dev)
    cost_table = torch.clamp(cost_base[None, :] * length_factor[:, None],
                             0, 1.0)
    return {
        "x": x, "task": task,
        "acc_table": acc_table, "cost_table": cost_table,
        "model_cost": cost_base, "model_quality": quality,
        "n_tasks": n_tasks, "n_models": n_models,
    }


def observe(gen: torch.Generator, corpus: dict, q_idx: torch.Tensor,
            m_idx: torch.Tensor, cost_noise: float = 0.02):
    """Sample the (acc, cost) a client actually logs for (query, model)."""
    p = corpus["acc_table"][q_idx, m_idx]
    acc = torch.bernoulli(p, generator=gen)
    cost = corpus["cost_table"][q_idx, m_idx]
    cost = torch.clamp(cost + cost_noise * torch.randn(
        cost.shape, generator=gen, device=cost.device), 0.0, 1.0)
    return acc, cost
