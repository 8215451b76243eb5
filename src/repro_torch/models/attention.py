"""Attention layer: GQA with RoPE and optional QKV bias (PyTorch counterpart
of ``repro/models/attention.py``, dense parts).

Paths:
  * ``attn_forward`` — prefill attention, computed in query chunks so the
    S×S score matrix is never materialized. Plain PyTorch: the reference
    runs prefill outside any Pallas kernel too.
  * ``attn_decode_step`` — one-token decode against a contiguous
    (B, Hkv, W, hd) cache; on CUDA through the ``decode_attention``
    kernel, on the CPU through ``_masked_grouped_attn``.
  * ``attn_decode_step_paged`` — one-token decode against the shared page
    pool; on CUDA through the ``paged_decode_attention`` kernel, on the
    CPU by gathering the pages and running ``_masked_grouped_attn``.

Caches are updated in place (the reference's donated buffers): the decode
steps write the new K/V into the tensors they are given and return them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import paged_gather_ref
from repro_torch.models import layers as L

NEG = -1e30


def init_attn(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = L.dtype_of(cfg)
    s = d ** -0.5
    p = {
        "wq": L.normal(gen, (d, hq * hd), s, dt),
        "wk": L.normal(gen, (d, hkv * hd), s, dt),
        "wv": L.normal(gen, (d, hkv * hd), s, dt),
        "wo": L.normal(gen, (hq * hd, d), (hq * hd) ** -0.5, dt),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=gen.device)
    if cfg.qk_norm:
        raise NotImplementedError("qk_norm attention is not ported yet")
    return p


def _project_qkv(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.apply_rope(q.reshape(B, S, hq, hd), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(B, S, hkv, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, hkv, hd)


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      q_chunk: int = 512):
    """Query-chunked attention in the grouped layout (KV never expanded to
    the query heads). q: (B,S,Hq,hd); k,v: (B,Sk,Hkv,hd).
    Returns (B,S,Hq*hd)."""
    B, S, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qc = min(q_chunk, S)
    while S % qc:
        qc //= 2
    scale = hd ** -0.5
    kpos = torch.arange(Sk, device=q.device)
    kf = k.float()
    outs = []
    for i in range(S // qc):
        q_blk = q[:, i * qc:(i + 1) * qc].reshape(B, qc, Hkv, g, hd)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", q_blk.float(), kf) * scale
        if causal:
            qpos = i * qc + torch.arange(qc, device=q.device)
            m = kpos[None, :] <= qpos[:, None]
            if window is not None:
                m &= (qpos[:, None] - kpos[None, :]) < window
            scores = torch.where(m, scores, torch.tensor(NEG, device=q.device))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
        outs.append(out.reshape(B, qc, Hq * hd))
    return torch.cat(outs, dim=1)


def attn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, *, window: Optional[int] = None,
                 q_chunk: int = 512, return_kv: bool = False):
    q, k, v = _project_qkv(p, x, cfg, positions)
    win = window if window is not None else (
        cfg.sliding_window if cfg.sliding_window_always else None)
    out = chunked_attention(q, k, v, causal=cfg.causal, window=win,
                            q_chunk=q_chunk) @ p["wo"]
    if return_kv:  # prefill: post-RoPE k/v become the decode cache
        return out, {"k": k.transpose(1, 2).contiguous(),
                     "v": v.transpose(1, 2).contiguous()}
    return out


# ---------------------------------------------------------------------------
# Decode with a KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
                  *, device) -> dict:
    """Cache layout (B, Hkv, S, hd), head-major like the reference."""
    dt = dtype or L.dtype_of(cfg)
    shape = (batch, cfg.n_kv_heads, cache_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _masked_grouped_attn(qg, k_cache, v_cache, valid):
    """The decode attention block shared by the contiguous and paged CPU
    paths — one definition, so engine tokens stay equal to solo tokens.
    qg: (B, Hkv, g, hd); caches (B, Hkv, K, hd); valid: (B|1, K) bool. Dot
    in the cache dtype with f32 accumulation (exact cache-dtype products
    summed in f32), probabilities rounded to the V dtype before p·v.
    Returns (B, Hkv, g, hd) in the cache dtype."""
    hd = qg.shape[-1]
    scores = torch.einsum("bhgd,bhkd->bhgk", qg.to(k_cache.dtype).float(),
                          k_cache.float()) * hd ** -0.5
    scores = torch.where(valid[:, None, None], scores,
                         torch.tensor(NEG, device=qg.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(v_cache.dtype)


def attn_decode_step(p: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, cfg: ModelConfig, *,
                     rolling: bool) -> tuple:
    """x: (B, 1, d); pos: int32 scalar (whole batch at one position) or
    (B,) vector (continuous batching: each cache row is a slot at its own
    position). Writes the new K/V into ``cache`` in place and returns
    (out, cache). rolling=True → the cache is a sliding window of length W
    written at ``pos % W``."""
    B = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    W = kc.shape[2]
    per_slot = pos.dim() == 1
    positions = pos[:, None] if per_slot else pos.reshape(1, 1)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    # the reference's dynamic_update_slice clamps the write into the cache
    slot = ((pos % W) if rolling else pos).clamp(0, W - 1).long()
    rows = torch.arange(B, device=x.device) if per_slot else slice(None)
    kc[rows, :, slot] = k_new[:, 0].to(kc.dtype)
    vc[rows, :, slot] = v_new[:, 0].to(vc.dtype)
    n_valid = torch.clamp(pos + 1, max=W)

    Hkv, hd, g = cfg.n_kv_heads, cfg.head_dim, cfg.q_per_kv
    qg = q.reshape(B, Hkv, g, hd)
    if kops.resolve_impl(None, qg) == "cuda":
        out = kops.decode_attention(qg, kc, vc, n_valid).to(vc.dtype)
    else:
        ar = torch.arange(W, device=x.device)[None, :]
        valid = ar < (n_valid[:, None] if per_slot else n_valid)
        out = _masked_grouped_attn(qg, kc, vc, valid)
    out = out.reshape(B, 1, cfg.n_heads * hd)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# Paged decode (page pool — serve/kv_cache.alloc_page_pool)
# ---------------------------------------------------------------------------


def init_paged_kv_cache(cfg: ModelConfig, pages: int, page_size: int,
                        dtype=None, *, device) -> dict:
    """One layer's page pool: (pages, Hkv, page_size, hd) page-major."""
    return init_kv_cache(cfg, pages, page_size, dtype, device=device)


def attn_decode_step_paged(p: dict, x: torch.Tensor, cache: dict,
                           page_table: torch.Tensor, pos: torch.Tensor,
                           cfg: ModelConfig) -> tuple:
    """One-token decode against the paged pool. x: (B, 1, d); cache leaves
    (P, Hkv, page_size, hd) shared by all rows; page_table: (B, npg) int32
    pool page per logical block; pos: (B,) int32 absolute positions.

    The new K/V lands at (page_table[b, pos_b // ps], pos_b % ps); rows
    whose entry is the trash page (0) scatter harmlessly there. Writes the
    pool in place and returns (out, cache)."""
    B = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    ps = kc.shape[2]
    npg = page_table.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])
    blk = torch.clamp(pos // ps, max=npg - 1).long()
    pages = page_table.long().gather(1, blk[:, None])[:, 0]
    off = (pos % ps).long()
    # duplicate targets only ever hit the trash page (inactive rows)
    kc[pages, :, off] = k_new[:, 0].to(kc.dtype)
    vc[pages, :, off] = v_new[:, 0].to(vc.dtype)

    Hkv, hd, g = cfg.n_kv_heads, cfg.head_dim, cfg.q_per_kv
    qg = q.reshape(B, Hkv, g, hd)
    if kops.resolve_impl(None, qg) == "cuda":
        out = kops.paged_decode_attention(qg, kc, vc, page_table, pos + 1)
    else:
        # the GATHER formulation, as the reference's CPU path: the softmax
        # normalizer and V sums reduce in logical-position order, like the
        # contiguous path, so engine tokens equal solo tokens
        n_valid = torch.clamp(pos + 1, max=npg * ps)
        valid = (torch.arange(npg * ps, device=x.device)[None, :]
                 < n_valid[:, None])
        out = _masked_grouped_attn(qg, paged_gather_ref(kc, page_table),
                                   paged_gather_ref(vc, page_table), valid)
    out = out.to(vc.dtype).reshape(B, 1, cfg.n_heads * hd)
    return out @ p["wo"], cache
