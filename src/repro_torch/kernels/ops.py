"""Dispatch for the port's kernels.

``impl="cuda"`` launches the hand-written CUDA kernel and ``impl="ref"``
runs its plain PyTorch version. With ``impl=None`` the ``REPRO_TORCH_KERNELS``
environment variable decides when set, and otherwise the tensors do: CPU
tensors take the plain version, CUDA tensors the kernel. Asking for the
kernel on CPU tensors raises — nothing falls back silently.

Under ``kernels.costs.OpCosts`` each entry records its kernel's
nominal work (FLOPs and bytes from the shapes, whatever implements it)
and nothing of its wrapper or plain version is counted.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kmeans_assign as _km
from repro_torch.kernels import router_utility as _ru
from repro_torch.kernels.costs import kernel as _counted
from repro_torch.kernels.costs import tensor_bytes as _bytes

_IMPLS = ("ref", "cuda")


def resolve_impl(impl: Optional[str], x) -> str:
    """"ref" or "cuda" for a call on tensor ``x`` (see the module doc)."""
    impl = impl or os.environ.get("REPRO_TORCH_KERNELS") or (
        "cuda" if x.is_cuda else "ref")
    if impl not in _IMPLS:
        raise ValueError(f"kernel impl {impl!r}: expected one of {_IMPLS}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; CPU tensors take "
                         "the plain version (impl='ref')")
    return impl


def router_utility(h, acc_w, acc_b, cost_w, cost_b, lam, *,
                   impl: Optional[str] = None):
    """(choice (n,) int32, best utility (n,) f32) of U = σ(h·Wa+ba) − λ(h·Wc+bc)."""
    def work():
        n, dh = h.shape
        return (4 * n * dh * acc_w.shape[1],
                _bytes(h, acc_w, acc_b, cost_w, cost_b) + 8 * n)
    with _counted("router_utility", work):
        if resolve_impl(impl, h) == "cuda":
            return _ru.router_utility_cuda(h, acc_w, acc_b, cost_w, cost_b,
                                           lam)
        return _ru.router_utility_plain(h, acc_w, acc_b, cost_w, cost_b, lam)


def decode_work(q, kv_dtype_size: int, S: int, extra_bytes: int) -> tuple:
    """Nominal (FLOPs, bytes) of one-token attention of q (B, Hkv, g, hd)
    over S cached positions of K and V: q·k and p·v at every position of
    the capacity, K and V read once, q read and the output written once
    in the cache's dtype, plus ``extra_bytes`` (bounds, page table)."""
    B, Hkv, g, hd = q.shape
    return (4 * B * Hkv * g * S * hd,
            _bytes(q) + 2 * B * Hkv * S * hd * kv_dtype_size
            + q.numel() * kv_dtype_size + extra_bytes)


def decode_attention(q, k_cache, v_cache, n_valid, *,
                     impl: Optional[str] = None):
    """One-token attention of q (B, Hkv, g, hd) over a (B, Hkv, S, hd) cache."""
    with _counted("decode_attention", lambda: decode_work(
            q, k_cache.element_size(), k_cache.shape[2], _bytes(n_valid))):
        if resolve_impl(impl, q) == "cuda":
            return _da.decode_attention_cuda(q, k_cache, v_cache, n_valid)
        return _da.decode_attention_plain(q, k_cache, v_cache, n_valid)


def paged_decode_attention(q, k_pool, v_pool, page_table, n_valid, *,
                           impl: Optional[str] = None):
    """One-token attention of q (B, Hkv, g, hd) over the pages that each
    row's ``page_table`` entry names in the (P, Hkv, ps, hd) pools."""
    with _counted("paged_decode_attention", lambda: decode_work(
            q, k_pool.element_size(), page_table.shape[1] * k_pool.shape[2],
            _bytes(page_table, n_valid))):
        if resolve_impl(impl, q) == "cuda":
            return _da.paged_decode_attention_cuda(q, k_pool, v_pool,
                                                   page_table, n_valid)
        return _da.paged_decode_attention_plain(q, k_pool, v_pool,
                                                page_table, n_valid)


def _kmeans_work(x, cents, w=None) -> tuple:
    """Nominal (FLOPs, bytes) of the assignment of x (n, d) | (G, n, d)
    to cents (K, d) | (P, K, d); with ``w`` also the weighted
    per-cluster sums and counts of a Lloyd step."""
    n, d = x.shape[-2:]
    K = cents.shape[-2]
    P = cents.shape[0] if cents.dim() == 3 else 1
    flops, nbytes = 2 * P * n * K * d, _bytes(x, cents) + 4 * P * n
    if w is not None:
        flops += 2 * P * n * d
        nbytes += _bytes(w) + 4 * P * K * (d + 1)
    return flops, nbytes


def kmeans_assign(x, cents, *, impl: Optional[str] = None):
    """Nearest-centroid index (int32) of each row of x (n, d) among cents
    (K, d); batched as x (G, n, d), cents (G·R, K, d) → (G·R, n)."""
    with _counted("kmeans_assign", lambda: _kmeans_work(x, cents)):
        if resolve_impl(impl, x) == "cuda":
            return _km.kmeans_assign_cuda(x, cents)
        return _km.kmeans_assign_plain(x, cents)


def kmeans_assign_reduce(x, cents, w, *, impl: Optional[str] = None):
    """One Lloyd step's work: the assignment plus the w-weighted
    per-cluster coordinate sums (K, d) and counts (K,), all f32; batched
    as ``kmeans_assign``, with w (G, n)."""
    with _counted("kmeans_assign_reduce", lambda: _kmeans_work(x, cents, w)):
        if resolve_impl(impl, x) == "cuda":
            return _km.kmeans_assign_reduce_cuda(x, cents, w)
        return _km.kmeans_assign_reduce_plain(x, cents, w)


def flash_attention(q, k, v, *, causal: bool = True,
                    impl: Optional[str] = None):
    """Prefill attention of q, k, v (B, S, H, hd) with equal head counts:
    f32 scores and softmax, p·v in f32, output in q's dtype."""
    def work():
        B, S, H, hd = q.shape
        return 4 * B * H * S * k.shape[1] * hd, _bytes(q, k, v) + _bytes(q)
    with _counted("flash_attention", work):
        if resolve_impl(impl, q) == "cuda":
            return _fa.flash_attention_cuda(q, k, v, causal=causal)
        return _fa.flash_attention_plain(q, k, v, causal=causal)


#: whether the flash kernel takes q's dtype and head dim
flash_takes = _fa.takes


_ALL_COUNTS = (_ru.COUNTS, _da.COUNTS, _km.COUNTS, _fa.COUNTS)


def launch_counts() -> Dict[str, int]:
    """Launches of every CUDA kernel since the last reset."""
    return {k: v for counts in _ALL_COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _ALL_COUNTS:
        for name in counts:
            counts[name] = 0
