"""Parametric MLP-Router (PyTorch counterpart of
``repro/core/mlp_router.py``; paper §4.1, Appendix C.1).

Shared trunk: hidden layers (512, 512), each Linear → LayerNorm → GELU.
Per-model heads: one accuracy logit (sigmoid at inference) and one
normalized cost scalar per model, kept as (d_h, M) matrices. The GELU is
the tanh approximation, as ``jax.nn.gelu`` defaults to it. Dropout and the
training loss wait for the port of the federated fit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def trunk_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = x
    for lyr in params["trunk"]:
        h = h @ lyr["w"] + lyr["b"]
        mu = h.mean(dim=-1, keepdim=True)
        var = h.var(dim=-1, unbiased=False, keepdim=True)
        h = (h - mu) * torch.rsqrt(var + 1e-5) * lyr["ln_s"] + lyr["ln_b"]
        h = F.gelu(h, approximate="tanh")
    return h


def apply_mlp_router(params: dict, x: torch.Tensor):
    """x: (B, d_emb) → (A (B, M) in [0,1], C (B, M))."""
    h = trunk_apply(params, x)
    hd = params["heads"]
    A = torch.sigmoid(h @ hd["acc_w"] + hd["acc_b"])
    C = h @ hd["cost_w"] + hd["cost_b"]
    return A, C
