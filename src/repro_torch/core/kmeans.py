"""Lloyd's K-means (PyTorch counterpart of ``repro/core/kmeans.py``; paper
Alg. 2 building block).

Per-point weights (server-side weighted K-means over client centroids) and
validity masks (padded per-client datasets). Batched: G data slabs
(clients) × R restarts run as G·R problems of one kernel launch per Lloyd
step (``kernels.ops.kmeans_assign_reduce``, the CUDA kernel on the card).
``lloyd`` is a function of its initial centroids, apart from the seeding.
"""
from __future__ import annotations

import torch

from repro_torch import sharding as shd
from repro_torch.kernels import ops as kops


def _plusplus_init(gen: torch.Generator, X: torch.Tensor, w: torch.Tensor,
                   K: int, R: int) -> torch.Tensor:
    """Weighted k-means++ seeding: R independent seedings of each slab of
    X (G, n, d) with weights w (G, n) → (G, R, K, d).

    ``gen`` is a generator or a ``sharding.ClientRows`` over the slabs.
    Each pick is drawn with ``torch.multinomial`` in proportion to
    weight × the running min squared distance to the centers so far. A
    slab with no probability mass left (fewer distinct weighted points
    than K) draws from its weights, or uniformly if they are all 0."""
    G, n, d = X.shape
    rows = torch.arange(G, device=X.device)[:, None]
    fallback = torch.where(w.sum(-1, keepdim=True) > 0, w,
                           torch.ones_like(w))[:, None].expand(G, R, n)

    def pick(p):                                     # (G, R, n) → (G, R, d)
        p = torch.where(torch.isfinite(p), p, 0.0)
        p = torch.where(p.sum(-1, keepdim=True) > 0, p, fallback)
        idx = shd.multinomial1(p.reshape(G * R, n), gen,
                               per=R).reshape(G, R)
        return X[rows, idx]

    cents = torch.zeros((G, R, K, d), dtype=X.dtype, device=X.device)
    cents[:, :, 0] = pick(w[:, None].expand(G, R, n))
    d2min = ((X[:, None] - cents[:, :, 0, None]) ** 2).sum(-1)
    for i in range(1, K):
        cents[:, :, i] = pick(d2min * w[:, None])
        d2min = torch.minimum(
            d2min, ((X[:, None] - cents[:, :, i, None]) ** 2).sum(-1))
    return cents


def lloyd(X: torch.Tensor, w: torch.Tensor, cents: torch.Tensor,
          iters: int):
    """Weighted Lloyd iterations from initial centroids cents (G, R, K, d)
    over the slabs X (G, n, d), w (G, n). Empty clusters keep their
    centroid. Returns (centroids (G, R, K, d), inertia (G, R), final
    assignment (G, R, n) int64)."""
    G, R, K, d = cents.shape
    n = X.shape[1]
    c = cents.reshape(G * R, K, d)
    for _ in range(iters):
        _, sums, cnts = kops.kmeans_assign_reduce(X, c, w)
        new = torch.where(cnts[..., None] > 0,
                          sums / torch.clamp(cnts, min=1e-12)[..., None], c)
        c = new.to(cents.dtype)
    assign = kops.kmeans_assign(X, c).reshape(G, R, n).long()
    c = c.reshape(G, R, K, d)
    near = torch.gather(c, 2, assign[..., None].expand(G, R, n, d))
    d2 = ((X[:, None] - near) ** 2).sum(-1)
    return c, (d2 * w[:, None]).sum(-1), assign


def _kmeans(gen, X, w, K: int, iters: int, n_init: int):
    """Batched weighted K-means with ``n_init`` restarts per slab: the
    restart of least inertia (first on ties) for each of the G slabs →
    (centroids (G, K, d), inertia (G,), its assignment (G, n))."""
    cents, inertia, assign = lloyd(X, w, _plusplus_init(gen, X, w, K, n_init),
                                   iters)
    best = torch.argmin(inertia, dim=1)
    rows = torch.arange(X.shape[0], device=X.device)
    return cents[rows, best], inertia[rows, best], assign[rows, best]


def kmeans(gen, X: torch.Tensor, K: int, *, iters: int = 30, n_init: int = 3,
           weights=None, mask=None):
    """Weighted Lloyd K-means with n_init restarts.

    X: (n, d) or a batch of slabs (G, n, d); weights: same leading shape or
    None; mask: bool — masked-out points get zero weight (padded rows).
    Returns (centroids (…, K, d), inertia (…))."""
    flat = X.ndim == 2
    X3 = X[None] if flat else X
    w = (torch.ones(X3.shape[:2], device=X.device) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32,
                              device=X.device).reshape(X3.shape[:2]))
    if mask is not None:
        w = w * mask.reshape(X3.shape[:2]).float()
    cents, inertia, _ = _kmeans(gen, X3, w, K, iters, n_init)
    return (cents[0], inertia[0]) if flat else (cents, inertia)
