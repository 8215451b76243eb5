"""Mamba2 (state-space duality / SSD) block [arXiv:2405.21060] (PyTorch
counterpart of ``repro/models/ssm.py``).

Prefill runs the chunked SSD form: intra-chunk terms are small dense
products (chunk × chunk decay-masked "attention"), and the inter-chunk
recurrence is a loop over chunk states. The recurrent state
(B, H, hd, state) and the last ``d_conv − 1`` raw conv inputs are the
decode cache. A single B/C group, broadcast across heads, as in the 370m
reference. The reference has no Pallas kernel here; this is plain PyTorch.

One difference from the reference, on purpose: a prefill of S < d_conv − 1
positions keeps a conv tail of exactly d_conv − 1 positions, left-padded
with zeros (the causal conv's own zero padding, and the state that
token-by-token decode from ``init_ssm_cache`` reaches). The reference's
tail slice wraps there and its next decode step fails.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state  # x, B, C all pass the depthwise conv
    return d_inner, n_heads, conv_dim


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, conv_dim = _dims(cfg)
    dt = L.dtype_of(cfg)
    dev = gen.device
    proj_dim = 2 * d_inner + 2 * s.d_state + H  # z, x, B, C, dt
    f32 = torch.float32
    return {
        "in_proj": L.normal(gen, (d, proj_dim), d ** -0.5, dt),
        "conv_w": L.normal(gen, (s.d_conv, conv_dim), 0.1, dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.zeros((H,), dtype=f32, device=dev),  # A = -1
        "D": torch.ones((H,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "norm": L.init_rmsnorm(d_inner, dt, dev),
        "out_proj": L.normal(gen, (d_inner, d), d_inner ** -0.5, dt),
    }


def _split_proj(proj, cfg: ModelConfig):
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    z, xBC, dt = torch.split(proj, [d_inner, d_inner + 2 * s.d_state, H],
                             dim=-1)
    return z, xBC, dt  # dt: (..., H)


def _split_xBC(xBC, cfg: ModelConfig):
    s = cfg.ssm
    d_inner, _, _ = _dims(cfg)
    return torch.split(xBC, [d_inner, s.d_state, s.d_state], dim=-1)


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over time, its taps summed in the model dtype.
    xBC: (B, S, C); w: (K, C)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return F.silu(out + b)


def mamba_forward(p: dict, x_in: torch.Tensor, cfg: ModelConfig, *,
                  return_state: bool = False):
    """Full-sequence (prefill) chunked-SSD forward. x_in: (B, S, d).
    return_state=True also returns the decode cache ({"conv", "state"})."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    hd, st = s.head_dim, s.d_state
    B_, S, _ = x_in.shape
    Q = min(s.chunk, S)
    while S % Q:  # shrink to a divisor of S (an odd S runs with Q = 1)
        Q //= 2
    nc = S // Q
    f32 = torch.float32

    proj = x_in @ p["in_proj"]
    z, xBC_raw, dt_raw = _split_proj(proj, cfg)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = _split_xBC(xBC, cfg)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])               # (B,S,H)
    A = -torch.exp(p["A_log"])                                   # (H,)
    xh = xs.reshape(B_, S, H, hd).float()

    def ch(a):
        return a.reshape((B_, nc, Q) + tuple(a.shape[2:]))

    dt_c = ch(dt)                      # (B,nc,Q,H)
    adt = dt_c * A                     # (B,nc,Q,H)  (= A·dt, negative)
    x_c = ch(xh)                       # (B,nc,Q,H,hd)
    B_c = ch(Bm.float())               # (B,nc,Q,st)
    C_c = ch(Cm.float())               # (B,nc,Q,st)
    xdt = x_c * dt_c[..., None]        # input scaled by dt

    acum = torch.cumsum(adt, dim=2)                              # (B,nc,Q,H)
    # intra-chunk decay Lmat[q, k] = exp(acum_q − acum_k) for q ≥ k; above
    # the diagonal exp can overflow to inf, so select, never multiply
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]       # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=x_in.device))[None, None, :, :, None]
    Lmat = torch.where(tri, torch.exp(diff),
                       torch.zeros((), device=x_in.device))
    # scores (B,nc,Q,Q) via C_q · B_k (single group → no head dim)
    cb = torch.einsum("bnqs,bnks->bnqk", C_c, B_c)
    y_diag = torch.einsum("bnqkh,bnkhd->bnqhd", cb[..., None] * Lmat, xdt)

    # per-chunk end states and the inter-chunk recurrence
    decay_to_end = torch.exp(acum[:, :, -1:, :] - acum)          # (B,nc,Q,H)
    chunk_state = torch.einsum("bnqs,bnqhd->bnhds", B_c,
                               decay_to_end[..., None] * xdt)
    chunk_decay = torch.exp(acum[:, :, -1, :])                   # (B,nc,H)
    h = torch.zeros((B_, H, hd, st), dtype=f32, device=x_in.device)
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, n, :, None, None] + chunk_state[:, n]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,nc,H,hd,st)

    decay_from_start = torch.exp(acum)                           # (B,nc,Q,H)
    y_off = torch.einsum("bnqs,bnhds->bnqhd", C_c, h_prevs) \
        * decay_from_start[..., None]

    y = (y_diag + y_off).reshape(B_, S, H, hd)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(B_, S, d_inner).to(x_in.dtype)
    # gated RMSNorm, then the output projection
    y = L.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    y = y @ p["out_proj"]
    if return_state:
        # the last K − 1 raw conv inputs, zeros before position 0
        tail = F.pad(xBC_raw, (0, 0, s.d_conv - 1, 0))[:, S:, :]
        return y, {"conv": tail.contiguous(), "state": h}
    return y


# ---------------------------------------------------------------------------
# Decode (single token) with the recurrent state cache
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=None, *,
                   device) -> dict:
    s = cfg.ssm
    d_inner, H, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                            dtype=dtype or L.dtype_of(cfg), device=device),
        "state": torch.zeros((batch, H, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }


def mamba_decode_step(p: dict, x_in: torch.Tensor, cache: dict,
                      cfg: ModelConfig) -> tuple:
    """x_in: (B, 1, d). Writes the new conv tail and state into ``cache``
    in place; returns (y (B, 1, d), cache)."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    hd = s.head_dim
    B_ = x_in.shape[0]

    proj = x_in[:, 0] @ p["in_proj"]                             # (B, proj)
    z, xBC, dt_raw = _split_proj(proj, cfg)
    # causal conv over (cached history, current), its taps summed in f32
    hist = torch.cat([cache["conv"], xBC[:, None, :].to(cache["conv"].dtype)],
                     dim=1)                                      # (B,K,C)
    conv_out = (torch.einsum("bkc,kc->bc", hist.float(), p["conv_w"].float())
                + p["conv_b"].float())
    xBC = F.silu(conv_out).to(x_in.dtype)
    xs, Bm, Cm = _split_xBC(xBC, cfg)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])               # (B,H)
    A = -torch.exp(p["A_log"])
    dec = torch.exp(A * dt)                                      # (B,H)
    xh = xs.reshape(B_, H, hd).float()
    Bf, Cf = Bm.float(), Cm.float()                              # (B,st)

    h = cache["state"] * dec[:, :, None, None] + (
        (dt[:, :, None] * xh)[..., None] * Bf[:, None, None, :])
    y = torch.einsum("bhds,bs->bhd", h, Cf) + p["D"][None, :, None] * xh
    y = y.reshape(B_, d_inner).to(x_in.dtype)
    y = L.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    y = (y @ p["out_proj"])[:, None, :]
    cache["conv"].copy_(hist[:, 1:, :])
    cache["state"].copy_(h)
    return y, cache
