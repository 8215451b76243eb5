"""The plain reference of a pool model and of the router, in PyTorch.

A frozen copy of the port's equations, written out once more without a
kernel, a cache, batching or padding: a decoder-only transformer with
RMSNorm, rotary positions (rotate-half, inverse frequencies θ^(-2i/hd)),
grouped-query causal attention with optional QKV bias, a SwiGLU MLP or a
top-k softmax mixture of SwiGLU experts (top-k weights renormalised, ties
to the lower expert id), a final RMSNorm and an untied unembedding. The
router is an MLP trunk (Linear → LayerNorm → tanh-GELU per layer) with an
accuracy head (sigmoid) and a cost head; a query goes to
argmax_m A_m − λ·C_m.

Everything runs in float32 (TF32 off) from the weights the benchmark
made, one layer at a time (each layer's weights upcast when it runs), one
sequence at a time, so a pool model of any size fits beside its bf16
weights. ``precision="fp8"`` is the control: every matrix product takes
its inputs rounded to float8 e4m3 (per output column of a weight, per row
of an activation, scaled to the format's largest finite value).

Imports torch only.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """f32 products in f32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in f32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., in) @ w (in, out) in f32, or on fp8-rounded inputs."""
    if precision == "fp8":
        x = fp8_round(x, -1)
        w = fp8_round(w, 0)
    return x @ w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """x (S, H, hd); positions (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h, W, m, precision):
    """Causal GQA over one sequence h (S, d)."""
    S = h.shape[0]
    hq, hkv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                   m["head_dim"])
    q = linear(h, W["wq"], precision)
    k = linear(h, W["wk"], precision)
    v = linear(h, W["wv"], precision)
    if "bq" in W:
        q, k, v = q + W["bq"], k + W["bk"], v + W["bv"]
    pos = torch.arange(S, device=h.device)
    q = rope(q.reshape(S, hq, hd), pos, m["rope_theta"])
    k = rope(k.reshape(S, hkv, hd), pos, m["rope_theta"])
    v = v.reshape(S, hkv, hd)
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
    return linear(out.reshape(S, hq * hd), W["wo"], precision)


def swiglu(x, wg, wu, wd, precision):
    return linear(F.silu(linear(x, wg, precision)) * linear(x, wu, precision),
                  wd, precision)


def moe(x, W, m, precision):
    """Top-k softmax routing over every expert; each token's output is
    the renormalised top-k weights times its experts' SwiGLU outputs."""
    probs = torch.softmax(x @ W["router"], dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = m["num_experts_per_tok"]
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(m["num_local_experts"]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if len(rows) == 0:
            continue
        y = swiglu(x[rows], W["wg"][e].float(), W["wu"][e].float(),
                   W["wd"][e].float(), precision)
        out.index_add_(0, rows, y * top_w[rows, slot][:, None])
    return out


def _layer_weights(params: dict, l: int, moe_layer: bool) -> Dict:
    b = params["blocks"]["l0"]
    W = {k: v[l].float() for k, v in b["mixer"].items()}
    W["norm1"] = b["norm1"]["scale"][l].float()
    W["norm2"] = b["norm2"]["scale"][l].float()
    ffn = b["ffn"]
    if moe_layer:       # experts upcast one at a time, in ``moe``
        W.update(router=ffn["router"][l].float(), wg=ffn["wg"][l],
                 wu=ffn["wu"][l], wd=ffn["wd"][l])
    else:
        W.update({k: ffn[k][l].float() for k in ("wg", "wu", "wd")})
    return W


@torch.no_grad()
def logits(m: dict, params: dict, seqs: Sequence[torch.Tensor],
           starts: Sequence[int], precision: str = "f32") -> List[torch.Tensor]:
    """For each token sequence (1-D int tensor on the weights' device),
    the f32 logits at positions starts[i] .. len - 1: row j predicts token
    starts[i] + j + 1."""
    eps = m["rms_norm_eps"]
    moe_layer = int(m.get("num_local_experts", 0)) > 0
    with no_tf32():
        tok = params["embed"]["tok"]
        hs = [tok[s.long()].float() for s in seqs]
        for l in range(m["num_hidden_layers"]):
            W = _layer_weights(params, l, moe_layer)
            for i, h in enumerate(hs):
                h = h + attention(rmsnorm(h, W["norm1"], eps), W, m,
                                  precision)
                x = rmsnorm(h, W["norm2"], eps)
                h = h + (moe(x, W, m, precision) if moe_layer else
                         swiglu(x, W["wg"], W["wu"], W["wd"], precision))
                hs[i] = h
            del W
        fn = params["final_norm"]["scale"].float()
        un = params["embed"]["unembed"].float()
        return [linear(rmsnorm(h[s0:], fn, eps), un, precision)
                for h, s0 in zip(hs, starts)]


@torch.no_grad()
def router_utility(state: dict, x: torch.Tensor, lam: torch.Tensor):
    """(U (Q, M)) = A − λ·C of the MLP router on queries x (Q, d_emb)."""
    with no_tf32():
        h = x.float()
        for lyr in state["trunk"]:
            h = h @ lyr["w"] + lyr["b"]
            mu = h.mean(-1, keepdim=True)
            var = ((h - mu) ** 2).mean(-1, keepdim=True)
            h = (h - mu) * torch.rsqrt(var + 1e-5) * lyr["ln_s"] + lyr["ln_b"]
            h = F.gelu(h, approximate="tanh")
        hd = state["heads"]
        A = torch.sigmoid(h @ hd["acc_w"] + hd["acc_b"])
        C = h @ hd["cost_w"] + hd["cost_b"]
        return A - lam[:, None] * C
