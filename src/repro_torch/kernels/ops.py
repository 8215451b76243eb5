"""Dispatch for the port's kernels.

``impl="cuda"`` launches the hand-written CUDA kernel and ``impl="ref"``
runs its plain PyTorch version. With ``impl=None`` the ``REPRO_TORCH_KERNELS``
environment variable decides when set, and otherwise the tensors do: CPU
tensors take the plain version, CUDA tensors the kernel. Asking for the
kernel on CPU tensors raises — nothing falls back silently.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import kmeans_assign as _km
from repro_torch.kernels import router_utility as _ru

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
    if resolve_impl(impl, h) == "cuda":
        return _ru.router_utility_cuda(h, acc_w, acc_b, cost_w, cost_b, lam)
    return _ru.router_utility_plain(h, acc_w, acc_b, cost_w, cost_b, lam)


def decode_attention(q, k_cache, v_cache, n_valid, *,
                     impl: Optional[str] = None):
    """One-token attention of q (B, Hkv, g, hd) over a (B, Hkv, S, hd) cache."""
    if resolve_impl(impl, q) == "cuda":
        return _da.decode_attention_cuda(q, k_cache, v_cache, n_valid)
    return _da.decode_attention_plain(q, k_cache, v_cache, n_valid)


def paged_decode_attention(q, k_pool, v_pool, page_table, n_valid, *,
                           impl: Optional[str] = None):
    """One-token attention of q (B, Hkv, g, hd) over the pages that each
    row's ``page_table`` entry names in the (P, Hkv, ps, hd) pools."""
    if resolve_impl(impl, q) == "cuda":
        return _da.paged_decode_attention_cuda(q, k_pool, v_pool, page_table,
                                               n_valid)
    return _da.paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                            n_valid)


def kmeans_assign(x, cents, *, impl: Optional[str] = None):
    """Nearest-centroid index (int32) of each row of x (n, d) among cents
    (K, d); batched as x (G, n, d), cents (G·R, K, d) → (G·R, n)."""
    if resolve_impl(impl, x) == "cuda":
        return _km.kmeans_assign_cuda(x, cents)
    return _km.kmeans_assign_plain(x, cents)


def kmeans_assign_reduce(x, cents, w, *, impl: Optional[str] = None):
    """One Lloyd step's work: the assignment plus the w-weighted
    per-cluster coordinate sums (K, d) and counts (K,), all f32; batched
    as ``kmeans_assign``, with w (G, n)."""
    if resolve_impl(impl, x) == "cuda":
        return _km.kmeans_assign_reduce_cuda(x, cents, w)
    return _km.kmeans_assign_reduce_plain(x, cents, w)


_ALL_COUNTS = (_ru.COUNTS, _da.COUNTS, _km.COUNTS)


def launch_counts() -> Dict[str, int]:
    """Launches of every CUDA kernel since the last reset."""
    return {k: v for counts in _ALL_COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _ALL_COUNTS:
        for name in counts:
            counts[name] = 0
