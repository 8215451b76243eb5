"""Routing policy: utility U_λ(x,m) = A(x,m) − λ·C(x,m) (PyTorch
counterpart of ``repro/core/policy.py``; paper Eq. 1/4).

Also the evaluation protocol of §6: accuracy–cost frontiers swept over a log
grid of λ and the normalized area-under-curve (AUC) summary. The frontier
is one batched pass over the whole λ grid.
"""
from __future__ import annotations

import numpy as np
import torch


def utility(A: torch.Tensor, C: torch.Tensor, lam) -> torch.Tensor:
    """A, C: (..., M) estimated accuracy / cost → utility (..., M)."""
    return A - lam * C


def route(A: torch.Tensor, C: torch.Tensor, lam) -> torch.Tensor:
    """argmax_m U_λ — chosen model indices (...,), first index on ties."""
    return torch.argmax(utility(A, C, lam), dim=-1)


def lambda_grid(num: int = 100, lo: float = 1e-2, hi: float = 1e7) -> np.ndarray:
    """Paper Appendix C: log grid λ ∈ [1e-2, 1e7], 100 points."""
    return np.logspace(np.log10(lo), np.log10(hi), num)


def frontier(A_est, C_est, acc_true, cost_true,
             lams=None) -> tuple[np.ndarray, np.ndarray]:
    """Sweep λ; route with *estimates*, score with *true* tables.

    A_est, C_est, acc_true, cost_true: (Q, M). Returns (costs, accs) f32
    arrays over the λ grid (mean over test queries)."""
    lams = lambda_grid() if lams is None else lams
    lam = torch.as_tensor(np.asarray(lams), dtype=torch.float32,
                          device=A_est.device)[:, None, None]
    m = route(A_est[None], C_est[None], lam)                     # (L, Q)
    Q = A_est.shape[0]
    take = lambda t: torch.gather(t[None].expand(m.shape[0], Q, -1), 2,
                                  m[..., None])[..., 0]
    costs = take(cost_true.float()).mean(dim=1)
    accs = take(acc_true.float()).mean(dim=1)
    return costs.cpu().numpy(), accs.cpu().numpy()


def frontier_auc(costs: np.ndarray, accs: np.ndarray) -> float:
    """Normalized AUC: integrate the *upper envelope* of accuracy as a
    function of cost, divided by the observed cost range (paper §6)."""
    costs = np.asarray(costs, dtype=np.float64)
    accs = np.asarray(accs, dtype=np.float64)
    order = np.argsort(costs)
    c, a = costs[order], accs[order]
    # Upper envelope: running max (a rational operator never does worse by
    # spending more — mirrors how the paper's monotone frontiers look).
    a = np.maximum.accumulate(a)
    # collapse duplicate costs to their best accuracy
    uc, idx = np.unique(c, return_index=True)
    ua = np.maximum.reduceat(a, idx)
    if len(uc) < 2:
        return float(ua[-1])
    area = np.trapezoid(ua, uc)
    return float(area / (uc[-1] - uc[0]))


def eval_router(predict_fn, x_test, acc_true, cost_true, lams=None):
    """predict_fn(x) → (A_est, C_est) each (Q, M). Returns (costs, accs, auc)."""
    A_est, C_est = predict_fn(x_test)
    costs, accs = frontier(A_est, C_est, acc_true, cost_true, lams)
    return costs, accs, frontier_auc(costs, accs)
