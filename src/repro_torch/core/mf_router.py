"""Parametric matrix-factorization router (PyTorch counterpart of
``repro/core/mf_router.py``; RouterBench / RouteLLM style).

A learned linear map projects the query embedding into a rank-r latent
space, and each model carries a learned r-dim factor per head:

    A(x, m) = sigmoid(<phi(x), v_m^acc> + b_m^acc),   phi(x) = x W + b
    C(x, m) =        <phi(x), v_m^cost> + b_m^cost

The params carry the MLP router's ``heads`` layout, so the fused
``router_utility`` kernel and the onboarding freeze mask apply unchanged
with phi(x) in place of the trunk features.

Like ``mlp_router``, every function also takes params stacked along a
leading client axis (each leaf (N, ...)) with inputs (N, B, d): the
federated fit trains the clients of a round as one batched pass, the
projection a ``bmm`` of x (N, B, d) with ``proj.w`` (N, d, r).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import RouterConfig
from repro_torch.core.mlp_router import _row


def init_mf_router(gen: torch.Generator, cfg: RouterConfig,
                   num_models: Optional[int] = None) -> dict:
    """Fresh f32 MF router drawn from ``gen``, on the generator's device."""
    M = num_models if num_models is not None else cfg.num_models
    r, dev = cfg.mf_rank, gen.device

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return {
        "proj": {"w": normal((cfg.d_emb, r), cfg.d_emb ** -0.5),
                 "b": torch.zeros((r,), device=dev)},
        "heads": {"acc_w": normal((r, M), r ** -0.5),
                  "acc_b": torch.zeros((M,), device=dev),
                  "cost_w": normal((r, M), r ** -0.5),
                  "cost_b": torch.zeros((M,), device=dev)},
    }


def factor_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, d_emb) → latent query factors phi(x): (B, r)."""
    return torch.matmul(x, params["proj"]["w"]) + _row(params["proj"]["b"])


def apply_mf_router(params: dict, x: torch.Tensor):
    """x: (B, d_emb) → (A (B, M) in [0,1], C (B, M))."""
    z = factor_apply(params, x)
    hd = params["heads"]
    A = torch.sigmoid(torch.matmul(z, hd["acc_w"]) + _row(hd["acc_b"]))
    C = torch.matmul(z, hd["cost_w"]) + _row(hd["cost_b"])
    return A, C


def mf_loss(params: dict, batch: dict, cfg: RouterConfig, *,
            gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Eq. 3 MSE on the single logged model per sample — the contract of
    ``mlp_router.router_loss`` (``gen`` is accepted and unused: the model
    has no dropout). Stacked params and (N, B, ...) batches give (N,)."""
    A, C = apply_mf_router(params, batch["x"])
    m = batch["m"].long()[..., None]
    a_hat = torch.gather(A, -1, m)[..., 0]
    c_hat = torch.gather(C, -1, m)[..., 0]
    err = (a_hat - batch["acc"]) ** 2 + (c_hat - batch["cost"]) ** 2
    w = batch.get("w")
    if w is None:
        return err.mean(dim=-1)
    return (err * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)


def add_model_factor(params: dict, gen: torch.Generator) -> dict:
    """§6.3 model onboarding: append a fresh factor column to each head."""
    hd = params["heads"]
    r = hd["acc_w"].shape[0]
    dev = hd["acc_w"].device

    def col():
        return torch.randn((r, 1), generator=gen, device=dev) * r ** -0.5

    zero = torch.zeros((1,), device=dev)
    new = {"acc_w": torch.cat([hd["acc_w"], col()], dim=1),
           "acc_b": torch.cat([hd["acc_b"], zero]),
           "cost_w": torch.cat([hd["cost_w"], col()], dim=1),
           "cost_b": torch.cat([hd["cost_b"], zero])}
    return {"proj": params["proj"], "heads": new}
