"""Composable model: dense / MoE / SSM / hybrid / encoder-only (PyTorch
counterpart of ``repro/models/model.py``).

A model is a stack of identical *units*; ``block_pattern`` describes the
layers inside one unit (one layer for most archs; for hybrids one
attention layer and P − 1 Mamba layers). Parameters keep the reference's
tree: ``params["blocks"]["l{i}"]`` holds layer i of every unit stacked
along a leading ``n_units`` axis (the reference builds that axis with
``vmap``), so weights convert one to one (``repro_torch.convert``). The
unit loop indexes that axis — views, no copies — where the reference
scans over it. MoE layers run ``moe_mode="dense"`` on every serving path,
as in the reference.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, generator, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S


Pattern = List[Tuple[str, Optional[str]]]


def block_pattern(cfg: ModelConfig) -> Tuple[int, Pattern]:
    """Returns (n_units, [(mixer, ffn), ...] for one unit)."""
    if cfg.arch_type == "ssm":
        return cfg.n_layers, [("mamba", None)]
    if cfg.arch_type == "hybrid":
        P = cfg.hybrid_attn_period
        if cfg.n_layers % P:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                             f"whole units of {P}")
        pat = []
        for i in range(P):
            mixer = "attn" if i == 0 else "mamba"
            ffn = ("moe" if (cfg.moe and i % cfg.moe_period
                             == cfg.moe_period - 1) else "mlp")
            pat.append((mixer, ffn))
        return cfg.n_layers // P, pat
    return cfg.n_layers, [("attn", "moe" if cfg.moe else "mlp")]


def _init_norm(cfg: ModelConfig, d: int, device):
    dt = L.dtype_of(cfg)
    return (L.init_layernorm(d, dt, device) if cfg.encoder_only
            else L.init_rmsnorm(d, dt, device))


def _norm(cfg: ModelConfig, p, x):
    return (L.layernorm if cfg.encoder_only else L.rmsnorm)(p, x,
                                                            cfg.norm_eps)


def _layer(tree, i: int):
    """Unit i's view of a stacked (n_units, ...) tree."""
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
    the peak low; one layer is only given its leading axis (no copy)."""
    def tree_map(f, tree):
        if isinstance(tree, dict):
            return {k: tree_map(f, v) for k, v in tree.items()}
        return f(tree)

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    first = fn()
    if n == 1:
        return tree_map(lambda t: t.unsqueeze(0), first)
    out = tree_map(lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                         device=t.device), first)
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
    dev = resolve_device(device)
    gen = generator(gen, dev)
    dt = L.dtype_of(cfg)
    d = cfg.d_model
    n_units, pat = block_pattern(cfg)
    emb = {}
    # the token table: text archs and VLMs (decode generates text tokens;
    # only the vision patches arrive as embeddings); the audio encoder
    # never embeds tokens (its vocab is a classification codebook)
    if cfg.frontend is None or cfg.supports_decode:
        emb["tok"] = L.normal(gen, (cfg.vocab, d), 0.02, dt)
    emb["unembed"] = L.normal(gen, (d, cfg.vocab), d ** -0.5, dt)
    params = {"final_norm": _init_norm(cfg, d, dev), "embed": emb}
    blocks = {}
    for i, (mixer, ffn) in enumerate(pat):
        lp = {"norm1": _stack(lambda: _init_norm(cfg, d, dev), n_units),
              "mixer": _stack(lambda: (A.init_attn(gen, cfg) if mixer == "attn"
                                       else S.init_mamba(gen, cfg)), n_units)}
        if ffn is not None:
            lp["norm2"] = _stack(lambda: _init_norm(cfg, d, dev), n_units)
            lp["ffn"] = _stack(lambda: (M.init_moe(gen, cfg) if ffn == "moe"
                                        else L.init_mlp(gen, cfg)), n_units)
        blocks[f"l{i}"] = lp
    params["blocks"] = blocks
    return params


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def active_param_count(params, cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE experts scaled by top_k/E)."""
    frac = (cfg.moe.top_k / cfg.moe.num_experts) if cfg.moe else 1.0
    total = 0
    for leaf in _leaves(params):
        if leaf.dim() == 4:  # stacked expert weights (n_units, E, d, f)
            total += int(leaf.numel() * frac)
        else:
            total += leaf.numel()
    return total


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _ffn(cfg: ModelConfig, ffn: str, p, x, moe_mode: str):
    """A layer's FFN on its normed input; returns (out, aux loss or None)."""
    if ffn == "moe":
        return M.moe_forward(p, x, cfg, mode=moe_mode)
    return L.mlp(p, x), None


def forward(params: dict, cfg: ModelConfig, *, tokens=None, embeds=None,
            moe_mode: str = "dense", q_chunk: int = 512,
            window: Optional[int] = None, logits_last_only: bool = False,
            last_pos=None, return_cache: bool = False):
    """Returns (logits, aux_loss[, cache]).

    logits_last_only — only one position per row is unembedded: the last,
    or ``last_pos`` — an int / 0-d tensor for the whole batch, or a (B,)
    tensor of per-row positions (coalesced prefill of right-padded prompts
    of different true lengths). return_cache — also return the decode
    cache: per layer of a unit, K/V leaves (n_units, B, Hkv, S, hd) or SSM
    leaves ``conv`` (n_units, B, d_conv − 1, C) and ``state``."""
    if embeds is None:
        embeds = L.embed(params["embed"], tokens)
    x = embeds.to(L.dtype_of(cfg))
    B, Sq, _ = x.shape
    positions = torch.arange(Sq, device=x.device)[None, :]
    n_units, pat = block_pattern(cfg)
    aux = torch.zeros((), device=x.device)
    caches = {f"l{i}": [] for i in range(len(pat))}
    for u in range(n_units):
        for i, (mixer, ffn) in enumerate(pat):
            lp = _layer(params["blocks"][f"l{i}"], u)
            h = _norm(cfg, lp["norm1"], x)
            if mixer == "attn":
                h = A.attn_forward(lp["mixer"], h, cfg, positions,
                                   window=window, q_chunk=q_chunk,
                                   return_kv=return_cache)
            else:
                h = S.mamba_forward(lp["mixer"], h, cfg,
                                    return_state=return_cache)
            if return_cache:
                h, c = h
                caches[f"l{i}"].append(c)
            x = x + h
            if ffn is not None:
                h, a = _ffn(cfg, ffn, lp["ffn"], _norm(cfg, lp["norm2"], x),
                            moe_mode)
                if a is not None:
                    aux = aux + a
                x = x + h
    x = _norm(cfg, params["final_norm"], x)
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
    if return_cache:
        cache = {name: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
                 for name, cs in caches.items()}
        return logits, aux, cache
    return logits, aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=None, *, device) -> dict:
    """Stacked (n_units leading dim) contiguous decode cache: K/V for
    attention layers, the conv tail and state for Mamba layers."""
    n_units, pat = block_pattern(cfg)
    out = {}
    for i, (mixer, _) in enumerate(pat):
        c = (A.init_kv_cache(cfg, batch, cache_len, dtype, device=device)
             if mixer == "attn"
             else S.init_ssm_cache(cfg, batch, dtype, device=device))
        out[f"l{i}"] = {k: torch.zeros((n_units,) + tuple(v.shape),
                                       dtype=v.dtype, device=v.device)
                        for k, v in c.items()}
    return out


def init_paged_cache(cfg: ModelConfig, pages: int, page_size: int,
                     dtype=None, *, device) -> dict:
    """Stacked paged decode cache: leaves (n_units, pages, Hkv, page_size,
    hd), one flat page pool per layer shared by every in-flight request.
    Attention-only: SSM state is not positional, so SSM/hybrid archs
    cannot be paged (they stay on the gateway's per-call path)."""
    if cfg.arch_type in ("ssm", "hybrid"):
        raise TypeError(f"{cfg.name}: paged KV pools require attention-only "
                        "archs — SSM state has no per-position pages")
    return init_decode_cache(cfg, pages, page_size, dtype, device=device)


def _decode(params, cache, cfg, tokens, embeds, attn):
    """One pass of every unit over decode-step inputs: ``attn`` runs an
    attention layer against its cache; Mamba layers step their state."""
    if embeds is None:
        embeds = L.embed(params["embed"], tokens)
    x = embeds.to(L.dtype_of(cfg))
    n_units, pat = block_pattern(cfg)
    for u in range(n_units):
        for i, (mixer, ffn) in enumerate(pat):
            lp = _layer(params["blocks"][f"l{i}"], u)
            c = _layer(cache[f"l{i}"], u)
            h = _norm(cfg, lp["norm1"], x)
            if mixer == "attn":
                h, _ = attn(lp["mixer"], h, c)
            else:
                h, _ = S.mamba_decode_step(lp["mixer"], h, c, cfg)
            x = x + h
            if ffn is not None:
                h, _ = _ffn(cfg, ffn, lp["ffn"], _norm(cfg, lp["norm2"], x),
                            "dense")
                x = x + h
    x = _norm(cfg, params["final_norm"], x)
    return L.unembed(params["embed"], x), cache


def decode_step(params: dict, cache: dict, cfg: ModelConfig, *,
                tokens=None, embeds=None, pos, rolling: bool = False):
    """One-token decode. tokens: (B,1) int or embeds: (B,1,d); pos: int32
    scalar or (B,) vector (continuous batching). Writes the cache in place;
    returns (logits (B,1,V), cache)."""
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
    give. Attention-only archs. Writes the slot pool in place; returns
    (logits, cache)."""
    if cfg.arch_type in ("ssm", "hybrid"):
        raise TypeError(f"{cfg.name}: speculative verify needs per-position "
                        "KV — SSM state cannot roll back a rejected suffix")
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
    dev = params_device(params)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    page_table = torch.as_tensor(page_table, dtype=torch.int32, device=dev)
    tokens = torch.as_tensor(tokens, device=dev)
    return _decode(params, cache, cfg, tokens, None,
                   lambda p, h, c: A.attn_decode_verify_paged(
                       p, h, c, page_table, pos, cfg))
