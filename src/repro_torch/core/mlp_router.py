"""Parametric MLP-Router (PyTorch counterpart of
``repro/core/mlp_router.py``; paper §4.1, Appendix C.1).

Shared trunk: hidden layers (512, 512), each Linear → LayerNorm → GELU.
Per-model heads: one accuracy logit (sigmoid at inference) and one
normalized cost scalar per model, kept as (d_h, M) matrices so onboarding
a model appends a column (§6.3). The GELU is the tanh approximation, as
``jax.nn.gelu`` defaults to it.

Every function here also takes params stacked along a leading client axis
(each leaf (N, ...)) with inputs (N, B, d): the federated fit trains all
clients of a round as one batched forward and backward pass.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.config import RouterConfig


def init_mlp_router(gen: torch.Generator, cfg: RouterConfig,
                    num_models: Optional[int] = None) -> dict:
    """Fresh f32 router state drawn from ``gen``, on the generator's
    device."""
    M = num_models if num_models is not None else cfg.num_models
    dev = gen.device
    dims = (cfg.d_emb,) + tuple(cfg.hidden)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    trunk = []
    for din, dout in zip(dims[:-1], dims[1:]):
        trunk.append({
            "w": normal((din, dout), din ** -0.5),
            "b": torch.zeros((dout,), device=dev),
            "ln_s": torch.ones((dout,), device=dev),
            "ln_b": torch.zeros((dout,), device=dev),
        })
    dh = dims[-1]
    heads = {
        "acc_w": normal((dh, M), dh ** -0.5),
        "acc_b": torch.zeros((M,), device=dev),
        "cost_w": normal((dh, M), dh ** -0.5),
        "cost_b": torch.zeros((M,), device=dev),
    }
    return {"trunk": trunk, "heads": heads}


def _row(v: torch.Tensor) -> torch.Tensor:
    """A bias or scale (…, k) shaped to broadcast over the rows of a batch:
    (k,) stays, stacked (N, k) becomes (N, 1, k)."""
    return v.unsqueeze(-2) if v.ndim > 1 else v


def trunk_apply(params: dict, x: torch.Tensor, *, dropout: float = 0.0,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Linear → LayerNorm → GELU per layer; with ``dropout > 0`` and a
    generator (or a ``sharding.ClientRows``), inverted dropout after each
    layer (keep with 1 − p, scale by 1/(1 − p))."""
    h = x
    for lyr in params["trunk"]:
        h = torch.matmul(h, lyr["w"]) + _row(lyr["b"])
        mu = h.mean(dim=-1, keepdim=True)
        var = h.var(dim=-1, unbiased=False, keepdim=True)
        h = ((h - mu) * torch.rsqrt(var + 1e-5) * _row(lyr["ln_s"])
             + _row(lyr["ln_b"]))
        h = F.gelu(h, approximate="tanh")
        if dropout > 0.0 and gen is not None:
            keep = shd.rand(h.shape, gen, device=h.device) < 1.0 - dropout
            h = torch.where(keep, h / (1.0 - dropout), 0.0)
    return h


def apply_mlp_router(params: dict, x: torch.Tensor, *, dropout: float = 0.0,
                     gen: Optional[torch.Generator] = None):
    """x: (B, d_emb) → (A (B, M) in [0,1], C (B, M)); stacked params take
    x (N, B, d_emb)."""
    h = trunk_apply(params, x, dropout=dropout, gen=gen)
    hd = params["heads"]
    A = torch.sigmoid(torch.matmul(h, hd["acc_w"]) + _row(hd["acc_b"]))
    C = torch.matmul(h, hd["cost_w"]) + _row(hd["cost_b"])
    return A, C


def router_loss(params: dict, batch: dict, cfg: RouterConfig, *,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Paper Eq. 3: MSE on the single logged model per sample.

    batch: {"x": (B,d), "m": (B,), "acc": (B,), "cost": (B,), optional
    "w": (B,) sample weights (0 for padding)}; dropout is drawn from
    ``gen`` when given. Stacked params and (N, B, ...) batches give one
    loss per client, (N,)."""
    A, C = apply_mlp_router(params, batch["x"], dropout=cfg.dropout, gen=gen)
    m = batch["m"].long()[..., None]
    a_hat = torch.gather(A, -1, m)[..., 0]
    c_hat = torch.gather(C, -1, m)[..., 0]
    err = (a_hat - batch["acc"]) ** 2 + (c_hat - batch["cost"]) ** 2
    w = batch.get("w")
    if w is None:
        return err.mean(dim=-1)
    return (err * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)


def add_model_head(params: dict, gen: torch.Generator) -> dict:
    """§6.3 model onboarding: append a fresh column to each head."""
    hd = params["heads"]
    dh = hd["acc_w"].shape[0]
    dev = hd["acc_w"].device

    def col():
        return torch.randn((dh, 1), generator=gen, device=dev) * dh ** -0.5

    zero = torch.zeros((1,), device=dev)
    new = {
        "acc_w": torch.cat([hd["acc_w"], col()], dim=1),
        "acc_b": torch.cat([hd["acc_b"], zero]),
        "cost_w": torch.cat([hd["cost_w"], col()], dim=1),
        "cost_b": torch.cat([hd["cost_b"], zero]),
    }
    return {"trunk": params["trunk"], "heads": new}
