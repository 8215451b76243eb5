"""Adaptive personalization (PyTorch counterpart of
``repro/core/personalization.py``; paper §6.4).

Each client holds the federated estimators and its locally trained ones;
per model m it computes mean-absolute calibration errors on its own logged
samples (no extra model calls) and mixes the two routers with weights
inversely proportional to those errors:

  w_a^{(i,m)} = e(A^fed_m) / (e(A^fed_m) + e(A^loc_m))        (local weight)
  A_mix = w_a · A^loc + (1 − w_a) · A^fed          (same for cost with w_c)
"""
from __future__ import annotations

import torch


def calibration_errors(predict_fn, data_i, num_models: int):
    """MAE of a router's acc/cost predictions on one client's own logged
    samples, per model. Models never logged locally get error = +inf (the
    mixture then falls back entirely to the other estimator).

    predict_fn(x) → (A (D,M), C (D,M)). Returns (e_acc (M,), e_cost (M,))."""
    A, C = predict_fn(data_i["x"])
    m = data_i["m"].long()
    w = data_i["w"].float()
    a_hat = torch.gather(A, 1, m[:, None])[:, 0]
    c_hat = torch.gather(C, 1, m[:, None])[:, 0]
    ae = (a_hat - data_i["acc"]).abs() * w
    ce = (c_hat - data_i["cost"]).abs() * w
    onehot = (torch.arange(num_models, device=m.device)[None, :]
              == m[:, None]).float() * w[:, None]
    n_m = onehot.sum(0)                                        # (M,)
    safe = torch.clamp(n_m, min=1e-12)
    inf = torch.tensor(float("inf"), device=m.device)
    e_acc = torch.where(n_m > 0, (ae[:, None] * onehot).sum(0) / safe, inf)
    e_cost = torch.where(n_m > 0, (ce[:, None] * onehot).sum(0) / safe, inf)
    return e_acc, e_cost


def mixture_weights(e_fed, e_loc):
    """Local-estimator weight per model; safe at the 0/∞ edges: 0 when the
    local error is ∞ (both ∞ included), 1 when only the federated one is."""
    w = torch.where(torch.isinf(e_loc), 0.0,
                    torch.where(torch.isinf(e_fed), 1.0,
                                e_fed / torch.clamp(e_fed + e_loc,
                                                    min=1e-12)))
    return torch.where(torch.isinf(e_fed) & torch.isinf(e_loc), 0.0, w)


def personalized_predict(fed_fn, loc_fn, w_a, w_c):
    """The mixed predictor (a closure over the per-model weights)."""
    def predict(x):
        Af, Cf = fed_fn(x)
        Al, Cl = loc_fn(x)
        A = w_a[None, :] * Al + (1.0 - w_a)[None, :] * Af
        C = w_c[None, :] * Cl + (1.0 - w_c)[None, :] * Cf
        return A, C
    return predict


def make_personalized(fed_fn, loc_fn, data_i, num_models: int):
    """End-to-end §6.4: calibrate both routers on the client's samples and
    return (the mixed predictor, (w_a, w_c))."""
    ef_a, ef_c = calibration_errors(fed_fn, data_i, num_models)
    el_a, el_c = calibration_errors(loc_fn, data_i, num_models)
    w_a = mixture_weights(ef_a, el_a)
    w_c = mixture_weights(ef_c, el_c)
    return personalized_predict(fed_fn, loc_fn, w_a, w_c), (w_a, w_c)
