"""Dense decoder model (PyTorch counterpart of ``repro/models/model.py``).

Parameters keep the reference's tree: ``params["blocks"]`` holds every
layer's weights stacked along a leading ``n_units`` axis (the reference
builds that axis with ``vmap``), so weights convert one to one
(``repro_torch.convert``). The layer loop indexes that axis — views, no
copies — where the reference scans over it. MoE, SSM and hybrid
architectures are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, generator, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.moe is not None or cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.name}: arch_type={cfg.arch_type!r} is not ported yet — the "
            "PyTorch port runs dense decoders only (MoE, SSM and hybrid "
            "stacks are queued in ROADMAP.md)")


def _layer(tree, i: int):
    """Layer i's view of a stacked (n_units, ...) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def params_device(params: dict) -> torch.device:
    return params["embed"]["unembed"].device


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _stack(fn, n: int) -> dict:
    """Call ``fn`` n times (one layer each) and stack every leaf of its
    (nested) dict, one layer at a time into a preallocated tensor to keep
    the peak low."""
    def empty(tree):
        if isinstance(tree, dict):
            return {k: empty(v) for k, v in tree.items()}
        return torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype,
                           device=tree.device)

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    first = fn()
    out = empty(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, fn(), i)
    return out


def init_params(gen: Union[torch.Generator, int], cfg: ModelConfig, *,
                device: DeviceLike = None) -> dict:
    """Random weights drawn from ``gen`` (a ``torch.Generator`` on the
    target device, or an int seed for one). Runs on the CUDA device unless
    ``device`` names another; raises without a GPU and without
    ``device="cpu"``."""
    _require_dense(cfg)
    dev = resolve_device(device)
    gen = generator(gen, dev)
    dt = L.dtype_of(cfg)
    d, n = cfg.d_model, cfg.n_layers
    params = {
        "final_norm": L.init_rmsnorm(d, dt, dev),
        "embed": {
            "tok": L.normal(gen, (cfg.vocab, d), 0.02, dt),
            "unembed": L.normal(gen, (d, cfg.vocab), d ** -0.5, dt),
        },
    }
    ones = torch.ones((n, d), dtype=dt, device=dev)
    params["blocks"] = {"l0": {
        "norm1": {"scale": ones},
        "mixer": _stack(lambda: A.init_attn(gen, cfg), n),
        "norm2": {"scale": ones.clone()},
        "ffn": _stack(lambda: L.init_mlp(gen, cfg), n),
    }}
    return params


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def forward(params: dict, cfg: ModelConfig, *, tokens=None, embeds=None,
            q_chunk: int = 512, window: Optional[int] = None,
            logits_last_only: bool = False, last_pos=None,
            return_cache: bool = False):
    """Returns (logits, aux_loss[, cache]).

    logits_last_only — only one position per row is unembedded: the last,
    or ``last_pos`` — an int / 0-d tensor for the whole batch, or a (B,)
    tensor of per-row positions (coalesced prefill of right-padded prompts
    of different true lengths). return_cache — also return the decode
    cache, leaves (n_units, B, Hkv, S, hd)."""
    _require_dense(cfg)
    if embeds is None:
        embeds = L.embed(params["embed"], tokens)
    x = embeds.to(L.dtype_of(cfg))
    B, Sq, _ = x.shape
    positions = torch.arange(Sq, device=x.device)[None, :]
    blocks = params["blocks"]["l0"]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(blocks, i)
        h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        h = A.attn_forward(lp["mixer"], h, cfg, positions, window=window,
                           q_chunk=q_chunk, return_kv=return_cache)
        if return_cache:
            h, kv = h
            ks.append(kv["k"])
            vs.append(kv["v"])
        x = x + h
        x = x + L.mlp(lp["ffn"], L.rmsnorm(lp["norm2"], x, cfg.norm_eps))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_last_only:
        if last_pos is None:
            x = x[:, -1:, :]
        else:
            lp_t = torch.as_tensor(last_pos, device=x.device).long()
            if lp_t.dim() == 1:            # per-row (coalesced prefill)
                x = x[torch.arange(B, device=x.device), lp_t][:, None, :]
            else:
                x = x.index_select(1, lp_t.reshape(1))
    logits = L.unembed(params["embed"], x)
    aux = torch.zeros((), device=x.device)
    if return_cache:
        return logits, aux, {"l0": {"k": torch.stack(ks),
                                    "v": torch.stack(vs)}}
    return logits, aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=None, *, device) -> dict:
    """Stacked (n_units leading dim) contiguous decode cache."""
    _require_dense(cfg)
    c = A.init_kv_cache(cfg, batch, cache_len, dtype, device=device)
    return {"l0": {k: torch.zeros((cfg.n_layers,) + tuple(v.shape),
                                  dtype=v.dtype, device=v.device)
                   for k, v in c.items()}}


def init_paged_cache(cfg: ModelConfig, pages: int, page_size: int,
                     dtype=None, *, device) -> dict:
    """Stacked paged decode cache: leaves (n_units, pages, Hkv, page_size,
    hd), one flat page pool per layer shared by every in-flight request."""
    return init_decode_cache(cfg, pages, page_size, dtype, device=device)


def _decode(params, cache, cfg, tokens, embeds, attn):
    if embeds is None:
        embeds = L.embed(params["embed"], tokens)
    x = embeds.to(L.dtype_of(cfg))
    blocks, pool = params["blocks"]["l0"], cache["l0"]
    for i in range(cfg.n_layers):
        lp = _layer(blocks, i)
        h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        h, _ = attn(lp["mixer"], h, _layer(pool, i))
        x = x + h
        x = x + L.mlp(lp["ffn"], L.rmsnorm(lp["norm2"], x, cfg.norm_eps))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x), cache


def decode_step(params: dict, cache: dict, cfg: ModelConfig, *,
                tokens=None, embeds=None, pos, rolling: bool = False):
    """One-token decode. tokens: (B,1) int or embeds: (B,1,d); pos: int32
    scalar or (B,) vector (continuous batching). Writes the cache in place;
    returns (logits (B,1,V), cache)."""
    _require_dense(cfg)
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=params_device(params))
    return _decode(params, cache, cfg, tokens, embeds,
                   lambda p, h, c: A.attn_decode_step(p, h, c, pos, cfg,
                                                      rolling=rolling))


def decode_step_paged(params: dict, cache: dict, cfg: ModelConfig, *,
                      tokens=None, embeds=None, page_table, pos):
    """One-token decode against the paged pool (``init_paged_cache``).
    page_table: (B, npg) int32 pool page ids per logical block, shared by
    every layer; pos: (B,) int32 per-row positions. Writes the pool in
    place; returns (logits (B,1,V), cache)."""
    _require_dense(cfg)
    dev = params_device(params)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    page_table = torch.as_tensor(page_table, dtype=torch.int32, device=dev)
    return _decode(params, cache, cfg, tokens, embeds,
                   lambda p, h, c: A.attn_decode_step_paged(
                       p, h, c, page_table, pos, cfg))


def decode_verify(params: dict, cache: dict, cfg: ModelConfig, *, tokens,
                  pos):
    """Speculative verify: T consecutive positions per row in one call.
    tokens: (B, T) int32 — each row's last committed token and its T - 1
    drafts; pos: (B,) int32 base positions (where tokens[:, 0] is
    written). K/V of all T positions is written ahead and each offset
    attends below its own causal bound, so the logits (B, T, V) are,
    position by position, what the one-token ``decode_step`` chain would
    give. Writes the slot pool in place; returns (logits, cache)."""
    _require_dense(cfg)
    dev = params_device(params)
    tokens = torch.as_tensor(tokens, device=dev)
    # the write-ahead's in-bounds indices, from the host positions, once
    # for all layers
    writes = A.verify_slot_writes(pos, tokens.shape[1],
                                  cache["l0"]["k"].shape[3], dev)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    return _decode(params, cache, cfg, tokens, None,
                   lambda p, h, c: A.attn_decode_verify(p, h, c, pos, cfg,
                                                        writes))


def decode_verify_paged(params: dict, cache: dict, cfg: ModelConfig, *,
                        tokens, page_table, pos):
    """Paged twin of ``decode_verify`` (pool from ``init_paged_cache``).
    tokens: (B, T) int32; page_table: (B, npg) int32; pos: (B,) int32.
    Write-ahead past a row's claimed pages lands in the trash page.
    Writes the pool in place; returns (logits (B, T, V), cache)."""
    _require_dense(cfg)
    dev = params_device(params)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    page_table = torch.as_tensor(page_table, dtype=torch.int32, device=dev)
    tokens = torch.as_tensor(tokens, device=dev)
    return _decode(params, cache, cfg, tokens, None,
                   lambda p, h, c: A.attn_decode_verify_paged(
                       p, h, c, page_table, pos, cfg))
