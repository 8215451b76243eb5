"""Mixture-of-Experts layer with top-k token-choice routing (PyTorch
counterpart of ``repro/models/moe.py``).

Two dispatch implementations (selected by ``mode``), as in the reference:

  * ``dense``    — computes every expert for every token and weights each
                   by the top-k gate. Exact (no token dropping); every
                   serving path runs it, so a token's output does not
                   depend on the other tokens of its batch.
  * ``capacity`` — Switch/GShard-style: tokens are sorted by expert id
                   (stable) and scattered into an (E, C, d) buffer with
                   C = max(1, int(T·top_k·cf) // E); experts run as batched
                   matmuls; outputs are gathered back and combined with the
                   gate weights. Tokens past an expert's capacity are
                   dropped.

Neither has a Pallas kernel in the reference, so both are plain PyTorch.
The router's load-balance auxiliary loss (Switch eq. 4) is returned beside
the output. The expert-parallel capacity dispatch on a mesh
(``_capacity_shard_map``) is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

#: tokens per dense-dispatch slice: the (E, T, f) and (E, T, d)
#: intermediates of one slice stay under ~0.6 GB at kimi-k2's width
#: (E 384, d 7168, f 2048, bf16). Tokens are independent, so slicing
#: changes no token's result.
_DENSE_TOKENS = 64


def _normal_experts(gen: torch.Generator, shape, scale: float, dtype):
    """``L.normal`` of an (E, ...) expert weight, drawn one expert at a
    time, so the f32 draw never holds more than one expert."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for e in range(shape[0]):
        out[e] = L.normal(gen, shape[1:], scale, dtype)
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.num_experts
    dt = L.dtype_of(cfg)
    s_in, s_out = d ** -0.5, f ** -0.5
    return {
        "router": L.normal(gen, (d, E), s_in, torch.float32),
        "wg": _normal_experts(gen, (E, d, f), s_in, dt),
        "wu": _normal_experts(gen, (E, d, f), s_in, dt),
        "wd": _normal_experts(gen, (E, f, d), s_out, dt),
    }


def _router_probs(p, x, cfg: ModelConfig):
    """x: (T, d) → top-k (weights (T, k), ids (T, k)), full probs (T, E).
    The logits are f32. Ties go to the lower expert id, as
    ``jax.lax.top_k`` orders them: a stable descending sort, sliced."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_w, top_ids = top_w[:, :k], top_ids[:, :k]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    return top_w, top_ids, probs


def _aux_loss(probs, top_ids, cfg: ModelConfig):
    E = cfg.moe.num_experts
    # fraction of tokens dispatched to each expert (first choice proxy)
    counts = torch.mean(F.one_hot(top_ids[:, 0], E).float(), dim=0)
    imp = torch.mean(probs, dim=0)
    return E * torch.sum(counts * imp)


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str = "dense", capacity_factor: float = 1.25) -> tuple:
    """x: (B, S, d) → (out (B, S, d), aux_loss scalar)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    top_w, top_ids, probs = _router_probs(p, xt, cfg)
    aux = _aux_loss(probs, top_ids, cfg) * cfg.moe.aux_coef
    if mode == "dense":
        out = _dense_dispatch(p, xt, top_w, top_ids, cfg)
    elif mode == "capacity":
        out = _capacity_dispatch(p, xt, top_w, top_ids, cfg, capacity_factor)
    else:
        raise ValueError(f"unknown moe mode {mode!r}")
    return out.reshape(B, S, d).to(x.dtype), aux


def _expert_mlp(p, xe):
    """xe: (E, C, d) → (E, C, d); batched SwiGLU over the expert dim."""
    g = F.silu(torch.bmm(xe, p["wg"]))
    u = torch.bmm(xe, p["wu"])
    return torch.bmm(g * u, p["wd"])


def _dense_dispatch(p, xt, top_w, top_ids, cfg: ModelConfig):
    """Every expert on every token, weighted by the gate. As in the
    reference, the gate is cast to the experts' output dtype before the
    last contraction and g·u is formed in the model dtype."""
    E = cfg.moe.num_experts
    T = xt.shape[0]
    # gate (T, E): top-k weights scattered into the full expert dim
    gate = torch.zeros((T, E), dtype=torch.float32, device=xt.device)
    gate.scatter_add_(1, top_ids, top_w)
    outs = []
    for t0 in range(0, T, _DENSE_TOKENS):
        xe = xt[t0:t0 + _DENSE_TOKENS].unsqueeze(0).expand(E, -1, -1)
        y = _expert_mlp(p, xe)                                 # (E, t, d)
        g = gate[t0:t0 + _DENSE_TOKENS].to(y.dtype)
        outs.append(torch.einsum("etd,te->td", y, g))
    return torch.cat(outs)


def _capacity_shard_map(p, xt, cfg: ModelConfig, cf: float):
    """The reference's expert-parallel capacity dispatch under
    ``shard_map``: mesh work, not ported (queued in ROADMAP.md)."""
    raise NotImplementedError(
        "moe: the expert-parallel capacity dispatch on a mesh "
        "(_capacity_shard_map) is not ported — the PyTorch port runs on one "
        "device (multi-device work is queued in ROADMAP.md)")


def _capacity_dispatch(p, xt, top_w, top_ids, cfg: ModelConfig, cf: float):
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    T, d = xt.shape
    C = max(1, int(T * k * cf) // E)
    dev = xt.device

    flat_e = top_ids.reshape(-1)                          # (T*k,)
    flat_w = top_w.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)

    order = torch.argsort(flat_e, stable=True)
    se, sw, stk = flat_e[order], flat_w[order], flat_t[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts             # exclusive cumsum
    pos = torch.arange(T * k, device=dev) - starts[se]    # slot in expert
    keep = pos < C
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))

    # dropped tokens add zeros at slot 0 of their expert
    buf = torch.zeros((E, C, d), dtype=xt.dtype, device=dev)
    buf.index_put_((se, pos_c), torch.where(keep[:, None], xt[stk],
                                            torch.zeros((), dtype=xt.dtype,
                                                        device=dev)),
                   accumulate=True)
    ye = _expert_mlp(p, buf)                              # (E, C, d)
    w = torch.where(keep, sw, torch.zeros_like(sw))[:, None].to(ye.dtype)
    y_tok = ye[se, pos_c] * w
    return torch.zeros((T, d), dtype=ye.dtype, device=dev).index_add_(
        0, stk, y_tok)
