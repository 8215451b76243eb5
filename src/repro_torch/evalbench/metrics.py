"""Frontier sweeps and AIQ-style scalar summaries (RouterBench, Hu et
al.; PyTorch counterpart of ``repro/evalbench/metrics.py``).

AIQ here is the normalized area under the non-decreasing upper envelope of
the λ-swept accuracy–cost frontier — ``core.policy.frontier_auc``. A
single point (a fixed model, a random router) degenerates to its
accuracy.

Reference points (RouterBench's "zero router" analysis):
  * ``zero_router`` — the frontier of the models themselves, each one
    (mean cost, mean acc) point;
  * ``best_single`` — the highest-accuracy single model;
  * ``random`` — uniform-random routing (mean of the model means);
  * ``oracle`` — routing with the true tables over the λ grid.

As in the reference, ``oracle_aiq`` is a λ-swept frontier area while
``best_single_aiq`` is one model's accuracy: on some draws the first is
the smaller, and both are reported as they come.
"""
from __future__ import annotations

import torch

from repro_torch.core import policy
from repro_torch.evalbench.pools import as_f64


def aiq(costs, accs) -> float:
    """Scalar frontier summary: normalized area under the upper envelope
    of accuracy as a function of cost (the accuracy itself for a single
    point)."""
    return policy.frontier_auc(costs, accs)


def sweep(predict_fn, test: dict, *, lams=None, x=None) -> dict:
    """λ-swept frontier of one router on one test draw.

    test: {"x": (Q,d), "acc_table": (Q,M), "cost_table": (Q,M)} — route
    with the router's estimates, score with the true tables. ``x``
    overrides the routed embeddings (perturbation scenarios route on the
    perturbed view while scoring keeps the true per-query tables).
    Returns {"costs", "accs", "aiq"}."""
    x_in = test["x"] if x is None else x
    costs, accs, auc = policy.eval_router(
        predict_fn, x_in, test["acc_table"], test["cost_table"], lams)
    return {"costs": costs, "accs": accs, "aiq": float(auc)}


def reference_points(test: dict, *, lams=None) -> dict:
    """The router-free reference points for one test draw (see the module
    doc). Returns {"zero_router_aiq", "best_single_aiq", "random_aiq",
    "oracle_aiq", "models": [(cost, acc), ...]}."""
    acc_t = as_f64(test["acc_table"])
    cost_t = as_f64(test["cost_table"])
    m_acc = acc_t.mean(axis=0)                      # (M,)
    m_cost = cost_t.mean(axis=0)
    acc, cost = (torch.as_tensor(test[k]) for k in ("acc_table",
                                                     "cost_table"))
    o_costs, o_accs = policy.frontier(acc, cost, acc, cost, lams)
    return {
        "zero_router_aiq": aiq(m_cost, m_acc),
        "best_single_aiq": float(m_acc.max()),
        "random_aiq": float(m_acc.mean()),
        "oracle_aiq": aiq(o_costs, o_accs),
        "models": [(float(c), float(a)) for c, a in zip(m_cost, m_acc)],
    }
