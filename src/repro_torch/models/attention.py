"""Attention layer: GQA with RoPE, optional QKV bias and optional qk-norm
(PyTorch counterpart of ``repro/models/attention.py``, dense parts).

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
  * ``attn_decode_verify`` / ``attn_decode_verify_paged`` — the
    speculative verify: T consecutive positions per row in one call. On
    CUDA each query goes through the same decode kernel, at the same
    ``n_valid``, as the one-token step would send it (T launches of
    ``decode_attention`` on the slot pool; one launch of
    ``paged_decode_attention`` with T folded into the batch on the page
    pool), so a verify position's attention is the one-token decode's; on
    the CPU through ``_masked_grouped_attn_multi``.

Caches are updated in place (the reference's donated buffers): the decode
steps write the new K/V into the tensors they are given and return them.

On a ``"heads"`` mesh (``sharding.HeadBlock``, ``heads=``) every decode
path takes this process's block of KV heads: the caches hold only those
heads, the projections run whole (the same products as without a mesh)
and keep the block's q, k and v heads (``q_per_kv`` unchanged), attention
runs on the local heads, and the heads' outputs are all-gathered in head
order before ``wo``. That is data movement only, so the output equals the
solo path's bit for bit; a row-parallel ``wo`` followed by an all-reduce
would sum in another order. Without ``heads`` nothing of this runs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import paged_gather_ref
from repro_torch.kernels.costs import kernel as counted
from repro_torch.kernels.costs import tensor_bytes
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
        p["q_norm"] = L.init_rmsnorm(hd, dt, gen.device)
        p["k_norm"] = L.init_rmsnorm(hd, dt, gen.device)
    return p


def _project_qkv(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k = q.reshape(B, S, hq, hd), k.reshape(B, S, hkv, hd)
    if cfg.qk_norm:             # per-head RMSNorm over hd, before RoPE
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, hkv, hd)


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      q_chunk: int = 512, layout: str = "grouped"):
    """Query-chunked attention. q: (B,S,Hq,hd); k,v: (B,Sk,Hkv,hd).
    Returns (B,S,Hq*hd). ``layout="grouped"`` never expands KV to the
    query heads; ``"flat"`` repeats each KV head to its g query heads
    first (the reference's layout for head-sharded meshes) and computes
    the same values."""
    if layout == "flat":
        g = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    elif layout != "grouped":
        raise ValueError(f"unknown attention layout {layout!r}")
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
                 q_chunk: int = 512, return_kv: bool = False,
                 layout: str = "grouped"):
    q, k, v = _project_qkv(p, x, cfg, positions)
    win = window if window is not None else (
        cfg.sliding_window if cfg.sliding_window_always else None)
    out = chunked_attention(q, k, v, causal=cfg.causal, window=win,
                            q_chunk=q_chunk, layout=layout) @ p["wo"]
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


def _grouped_attn(qg, k_cache, v_cache, mask):
    """The decode attention block shared by every CPU path (one-token,
    paged, verify) — one definition, so engine tokens stay equal to solo
    tokens. qg: (B, Hkv, G, hd); caches (B, Hkv, K, hd); mask broadcasts
    to (B, Hkv, G, K). Dot in the cache dtype with f32 accumulation (exact
    cache-dtype products summed in f32), probabilities rounded to the V
    dtype before p·v. Returns (B, Hkv, G, hd) in the cache dtype."""
    hd = qg.shape[-1]
    scores = torch.einsum("bhgd,bhkd->bhgk", qg.to(k_cache.dtype).float(),
                          k_cache.float()) * hd ** -0.5
    scores = torch.where(mask, scores, torch.tensor(NEG, device=qg.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(v_cache.dtype)


def _masked_grouped_attn(qg, k_cache, v_cache, valid):
    """One query token per row. qg: (B, Hkv, g, hd); caches
    (B, Hkv, K, hd); valid: (B|1, K) bool."""
    return _grouped_attn(qg, k_cache, v_cache, valid[:, None, None])


def _masked_grouped_attn_multi(qg, k_cache, v_cache, valid):
    """T query positions per row (the speculative verify), folded into the
    query-group axis so each folded row is the same dot, masked softmax
    and dot as a lone decode query; only the causal bound varies per
    offset. qg: (B, Hkv, T, g, hd); caches (B, Hkv, K, hd); valid:
    (B, T, K) bool. Returns (B, Hkv, T, g, hd) in the cache dtype."""
    B, Hkv, T, g, hd = qg.shape
    K = k_cache.shape[2]
    mask = valid[:, None, :, None, :].expand(B, Hkv, T, g, K)
    out = _grouped_attn(qg.reshape(B, Hkv, T * g, hd), k_cache, v_cache,
                        mask.reshape(B, Hkv, T * g, K))
    return out.reshape(B, Hkv, T, g, hd)


def attn_decode_step(p: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, cfg: ModelConfig, *,
                     rolling: bool, heads=None) -> tuple:
    """x: (B, 1, d); pos: int32 scalar (whole batch at one position) or
    (B,) vector (continuous batching: each cache row is a slot at its own
    position). Writes the new K/V into ``cache`` in place and returns
    (out, cache). rolling=True → the cache is a sliding window of length W
    written at ``pos % W``. ``heads``: this process's ``HeadBlock``, whose
    KV heads the cache holds."""
    B = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    W = kc.shape[2]
    per_slot = pos.dim() == 1
    positions = pos[:, None] if per_slot else pos.reshape(1, 1)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    if heads is not None:
        q, k_new, v_new = heads.take(q, k_new, v_new, cfg.q_per_kv)
    # the reference's dynamic_update_slice clamps the write into the cache
    # (a row index per row even for one position: a 0-d index tensor
    # would be read on the host)
    slot = ((pos % W) if rolling else pos).clamp(0, W - 1).long().expand(B)
    rows = torch.arange(B, device=x.device)
    kc[rows, :, slot] = k_new[:, 0].to(kc.dtype)
    vc[rows, :, slot] = v_new[:, 0].to(vc.dtype)
    n_valid = torch.clamp(pos + 1, max=W)

    Hkv, hd, g = kc.shape[1], cfg.head_dim, cfg.q_per_kv
    qg = q.reshape(B, Hkv, g, hd)
    if kops.resolve_impl(None, qg) == "cuda":
        out = kops.decode_attention(qg, kc, vc, n_valid).to(vc.dtype)
    else:
        # the kernel's function on the CPU, counted as the kernel
        with counted("decode_attention", lambda: kops.decode_work(
                qg, kc.element_size(), W, tensor_bytes(n_valid))):
            ar = torch.arange(W, device=x.device)[None, :]
            valid = ar < (n_valid[:, None] if per_slot else n_valid)
            out = _masked_grouped_attn(qg, kc, vc, valid)
    if heads is not None:
        out = heads.gather(out)
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
                           cfg: ModelConfig, heads=None) -> tuple:
    """One-token decode against the paged pool. x: (B, 1, d); cache leaves
    (P, Hkv, page_size, hd) shared by all rows; page_table: (B, npg) int32
    pool page per logical block; pos: (B,) int32 absolute positions.

    The new K/V lands at (page_table[b, pos_b // ps], pos_b % ps); rows
    whose entry is the trash page (0) scatter harmlessly there. Writes the
    pool in place and returns (out, cache). ``heads`` as in
    ``attn_decode_step``."""
    B = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    ps = kc.shape[2]
    npg = page_table.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])
    if heads is not None:
        q, k_new, v_new = heads.take(q, k_new, v_new, cfg.q_per_kv)
    blk = torch.clamp(pos // ps, max=npg - 1).long()
    pages = page_table.long().gather(1, blk[:, None])[:, 0]
    off = (pos % ps).long()
    # duplicate targets only ever hit the trash page (inactive rows)
    kc[pages, :, off] = k_new[:, 0].to(kc.dtype)
    vc[pages, :, off] = v_new[:, 0].to(vc.dtype)

    Hkv, hd, g = kc.shape[1], cfg.head_dim, cfg.q_per_kv
    qg = q.reshape(B, Hkv, g, hd)
    nv = pos + 1
    if kops.resolve_impl(None, qg) == "cuda":
        out = kops.paged_decode_attention(qg, kc, vc, page_table, nv)
    else:
        # the GATHER formulation, as the reference's CPU path: the softmax
        # normalizer and V sums reduce in logical-position order, like the
        # contiguous path, so engine tokens equal solo tokens; counted as
        # the kernel
        with counted("paged_decode_attention", lambda: kops.decode_work(
                qg, kc.element_size(), npg * ps,
                tensor_bytes(page_table, nv))):
            n_valid = torch.clamp(nv, max=npg * ps)
            valid = (torch.arange(npg * ps, device=x.device)[None, :]
                     < n_valid[:, None])
            out = _masked_grouped_attn(qg, paged_gather_ref(kc, page_table),
                                       paged_gather_ref(vc, page_table),
                                       valid)
    out = out.to(vc.dtype)
    if heads is not None:
        out = heads.gather(out)
    out = out.reshape(B, 1, cfg.n_heads * hd)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# Speculative multi-position verify (serve/engine.py draft/verify rounds)
# ---------------------------------------------------------------------------


def verify_positions(pos: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T) absolute positions pos_b + t of a verify window."""
    return pos[:, None] + torch.arange(T, dtype=pos.dtype,
                                       device=pos.device)[None, :]


def verify_slot_writes(pos, T: int, W: int, device) -> tuple:
    """The in-bounds (row, offset, position) index triple of a verify
    window's write-ahead into a slot pool of W positions. Positions ≥ W
    are DROPPED, never clamped: a clamp would land the drafts on the
    region's live tail. Computed on the host (``pos`` is host data in the
    engine), so the layers' writes need no device sync."""
    p = np.asarray(pos.cpu() if isinstance(pos, torch.Tensor) else pos,
                   np.int64).reshape(-1)
    b, t = np.nonzero(p[:, None] + np.arange(T)[None, :] < W)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (b, t, p[b] + t))


def attn_decode_verify(p: dict, x: torch.Tensor, cache: dict,
                       pos: torch.Tensor, cfg: ModelConfig,
                       writes: tuple, heads=None) -> tuple:
    """Multi-position decode against the uniform slot pool: row b carries
    T consecutive tokens at positions pos_b .. pos_b + T - 1 (the last
    committed token and the drafted window). x: (B, T, d); pos: (B,)
    int32. All T K/V entries are written before attention (write-ahead:
    query offset t sees positions < pos_b + t + 1, the drafts of this call
    included); positions ≥ W are dropped: ``writes`` is the window's
    ``verify_slot_writes``, computed once for all layers. A rejected
    suffix rolls back by the engine not advancing ``pos``: its stale K/V
    stays masked until a later step overwrites it. Writes the pool in
    place; returns (out (B, T, d), cache). ``heads`` as in
    ``attn_decode_step``."""
    B, T, _ = x.shape
    kc, vc = cache["k"], cache["v"]
    W = kc.shape[2]
    positions = verify_positions(pos, T)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)  # (B, T, H*, hd)
    if heads is not None:
        q, k_new, v_new = heads.take(q, k_new, v_new, cfg.q_per_kv)
    b, t, w = writes
    kc[b, :, w] = k_new[b, t].to(kc.dtype)
    vc[b, :, w] = v_new[b, t].to(vc.dtype)
    n_valid = torch.clamp(positions + 1, max=W)            # (B, T)
    qg = q.reshape(B, T, kc.shape[1], cfg.q_per_kv, cfg.head_dim)
    out = verify_attention(qg, kc, vc, n_valid)
    if heads is not None:
        out = heads.gather(out)
    return out.reshape(B, T, -1) @ p["wo"], cache


def verify_attention(qg, kc, vc, n_valid):
    """Attention of a verify window over a slot pool. qg:
    (B, T, Hkv, g, hd); caches (B, Hkv, W, hd); n_valid (B, T) ≤ W. On
    CUDA one ``decode_attention`` launch per offset, each the one-token
    step's launch on the same cache at the same n_valid (folding T into
    the batch would copy the cache). Returns (B, T, Hkv, g, hd) in the
    cache dtype."""
    T, W = qg.shape[1], kc.shape[2]
    if kops.resolve_impl(None, qg) == "cuda":
        return torch.stack([kops.decode_attention(
            qg[:, i], kc, vc, n_valid[:, i].to(torch.int32).contiguous()
        ).to(vc.dtype) for i in range(T)], dim=1)
    valid = (torch.arange(W, device=qg.device)[None, None, :]
             < n_valid[:, :, None])
    return _masked_grouped_attn_multi(qg.transpose(1, 2), kc, vc,
                                      valid).transpose(1, 2)


def attn_decode_verify_paged(p: dict, x: torch.Tensor, cache: dict,
                             page_table: torch.Tensor, pos: torch.Tensor,
                             cfg: ModelConfig, heads=None) -> tuple:
    """Multi-position decode against the page pool — the paged twin of
    ``attn_decode_verify``. x: (B, T, d); page_table: (B, npg) int32;
    pos: (B,) int32. Each position's K/V lands in its own page; positions
    past the table's extent (npg · ps), and blocks whose table entry is 0,
    land in the trash page, so speculative overflow never touches a live
    page. On CUDA the T offsets fold into the batch: one launch of the
    paged kernel over B·T rows, each row's table repeated and
    n_valid = min(pos + t + 1, npg · ps). Writes the pool in place;
    returns (out (B, T, d), cache). ``heads`` as in
    ``attn_decode_step``."""
    B, T, _ = x.shape
    kc, vc = cache["k"], cache["v"]
    ps = kc.shape[2]
    npg = page_table.shape[1]
    positions = verify_positions(pos, T)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)  # (B, T, H*, hd)
    if heads is not None:
        q, k_new, v_new = heads.take(q, k_new, v_new, cfg.q_per_kv)
    blk = torch.clamp(positions // ps, max=npg - 1).long()
    pages = page_table.long().gather(1, blk)
    pages = torch.where(positions < npg * ps, pages,
                        torch.zeros_like(pages))          # overflow → trash
    off = (positions % ps).long()
    # duplicate targets only ever hit the trash page
    kc[pages, :, off] = k_new.to(kc.dtype)
    vc[pages, :, off] = v_new.to(vc.dtype)
    n_valid = torch.clamp(positions + 1, max=npg * ps)    # (B, T)
    qg = q.reshape(B, T, kc.shape[1], cfg.q_per_kv, cfg.head_dim)
    out = verify_attention_paged(qg, kc, vc, page_table, n_valid)
    if heads is not None:
        out = heads.gather(out)
    return out.reshape(B, T, -1) @ p["wo"], cache


def verify_attention_paged(qg, kc, vc, page_table, n_valid):
    """Attention of a verify window over the page pool. qg:
    (B, T, Hkv, g, hd); pools (P, Hkv, ps, hd); page_table (B, npg);
    n_valid (B, T) ≤ npg · ps. On CUDA the T offsets fold into the batch:
    ONE ``paged_decode_attention`` launch over B·T rows, row (b, t) with
    b's table and n_valid[b, t] — the kernel computes each row alone, so
    this is the one-token step's result for that query. Returns
    (B, T, Hkv, g, hd) in the cache dtype."""
    B, T, Hkv, g, hd = qg.shape
    if kops.resolve_impl(None, qg) == "cuda":
        out = kops.paged_decode_attention(
            qg.reshape(B * T, Hkv, g, hd), kc, vc,
            page_table.repeat_interleave(T, dim=0),
            n_valid.reshape(-1).to(torch.int32))
        return out.to(vc.dtype).reshape(B, T, Hkv, g, hd)
    K = page_table.shape[1] * kc.shape[2]
    valid = (torch.arange(K, device=qg.device)[None, None, :]
             < n_valid[:, :, None])
    return _masked_grouped_attn_multi(
        qg.transpose(1, 2), paged_gather_ref(kc, page_table),
        paged_gather_ref(vc, page_table), valid).transpose(1, 2)
