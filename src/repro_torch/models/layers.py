"""Shared neural-net building blocks (PyTorch counterpart of
``repro/models/layers.py``).

Conventions, as in the reference:
  * params are nested dicts of tensors; init functions take an explicit
    ``torch.Generator`` that lives on the target device.
  * activations run in ``cfg.dtype``; norms and RoPE compute in f32.
  * weight layout: x @ W with W of shape (in, out).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """scale * N(0, 1) drawn in f32 on the generator's device, then cast."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)  # jnp.var
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    # (head_dim/2,) inverse frequencies, f32.
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    ang = positions.float()[..., None] * inv                # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU for decoder archs, GELU for the encoder-only audio arch) and
# embedding
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    if cfg.encoder_only:  # GELU MLP (hubert / w2v2 style)
        return {
            "wi": normal(gen, (d, f), d ** -0.5, dt),
            "bi": torch.zeros((f,), dtype=dt, device=gen.device),
            "wo": normal(gen, (f, d), f ** -0.5, dt),
            "bo": torch.zeros((d,), dtype=dt, device=gen.device),
        }
    return {
        "wg": normal(gen, (d, f), d ** -0.5, dt),
        "wu": normal(gen, (d, f), d ** -0.5, dt),
        "wd": normal(gen, (f, d), f ** -0.5, dt),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "wi" in p:  # GELU; jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["wi"] + p["bi"], approximate="tanh")
        return h @ p["wo"] + p["bo"]
    g = F.silu(x @ p["wg"])
    return (g * (x @ p["wu"])) @ p["wd"]


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["unembed"]
