"""Nonparametric K-Means-Router — paper Algorithm 2 (PyTorch counterpart of
``repro/core/kmeans_router.py``).

One-shot federated clustering: (i) each client runs local K-means and
uploads (centroid, size) pairs; (ii) the server runs size-weighted K-means
over the uploaded centroids; (iii) clients compute per-(cluster, model)
accuracy/cost sums + counts against the global centers; (iv) the server
aggregates count-weighted statistics. Inference: nearest global center →
cluster-level utility argmax.

A router is a dict θ = {"centroids": (K,d), "A": (K,M), "C": (K,M),
"n": (K,M)} — exactly the parameterization in Alg. 2 line 15. (k,m) cells
with no samples fall back to that model's global (count-weighted) mean; a
model never observed anywhere gets the pessimistic (acc 0, cost c_max).

Stage (i) runs every client's restarts as one batch of Lloyd problems.
The per-cluster sums are one-hot products (fixed summation order on the
card, no atomics), so a fit with one generator seed reproduces bit for
bit. ``client_mask`` (App. D.3) leaves masked clients out of the server's
K-means and the statistics. ``fed_kmeans_router_sharded`` runs stage (i)
on each process's block of a clients mesh, equal to the in-process fit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.config import RouterConfig
from repro_torch.core.kmeans import _kmeans, kmeans
from repro_torch.kernels import ops as kops


def _cluster_stats(centroids, data, K: int, M: int):
    """Sums/counts of acc & cost per (cluster, model) (Alg. 2 lines 9–12)
    for one client (flat data) or each client of a stack: (…, K, M) each."""
    s = _cluster_sums(centroids, data, K, M)
    return s[..., 1], s[..., 2], s[..., 0]


def _cluster_sums(centroids, data, K: int, M: int):
    """``_cluster_stats`` as one (…, K, M, 3) tensor of (count, acc sum,
    cost sum)."""
    x = data["x"]
    lead = x.shape[:-1]                              # (D,) or (N, D)
    assign = kops.kmeans_assign(x.reshape(-1, x.shape[-1]), centroids)
    idx = assign.long().reshape(lead) * M + data["m"].long()
    w = data["w"].float()
    vals = torch.stack([w, w * data["acc"], w * data["cost"]], dim=-1)
    onehot = F.one_hot(idx, K * M).float()           # (…, D, K·M)
    s = torch.matmul(onehot.transpose(-1, -2), vals)  # (…, K·M, 3)
    return s.reshape(s.shape[:-2] + (K, M, 3))


def _finalize(a_sum, c_sum, n, c_max: float):
    """Aggregate sums → estimators with the empty-cell fallback."""
    has = n > 0
    tot_n = n.sum(0)                                            # (M,)
    safe = torch.clamp(tot_n, min=1e-12)
    ga = torch.where(tot_n > 0, a_sum.sum(0) / safe, 0.0)
    gc = torch.where(tot_n > 0, c_sum.sum(0) / safe, c_max)
    nn = torch.clamp(n, min=1e-12)
    A = torch.where(has, a_sum / nn, ga[None, :])
    C = torch.where(has, c_sum / nn, gc[None, :])
    return A, C


def _mask(client_mask, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(client_mask, dtype=torch.float32,
                           device=like.device)


def _local_uploads(gen, data, rcfg: RouterConfig):
    """Alg. 2 stage (i) on a stack of clients at once (padded rows weigh
    0): each client's (centroids (k_local, d), sizes (k_local,))."""
    kl = rcfg.k_local
    cents, _, assign = _kmeans(gen, data["x"], (data["w"] > 0).float(), kl,
                               rcfg.kmeans_iters, rcfg.n_init)
    sizes = (F.one_hot(assign, kl).float() * data["w"][..., None]).sum(1)
    return cents, sizes


def fed_centroids(gen, data, rcfg: RouterConfig, *, client_mask=None):
    """Alg. 2 stages (i)+(ii): local K-means per client (centroid, size
    uploads) → server size-weighted K-means → (k_global, d) centers.
    ``client_mask`` (N,) zeroes the sizes that masked clients upload.
    Shared by every one-shot family that anchors statistics to a federated
    partition of embedding space (K-means, Elo)."""
    N, D, d = data["x"].shape
    kl = rcfg.k_local
    cents, sizes = _local_uploads(gen, data, rcfg)
    if client_mask is not None:
        sizes = sizes * _mask(client_mask, sizes)[:, None]
    # (ii) server: size-weighted K-means over the uploaded centroids
    centroids, _ = kmeans(gen, cents.reshape(N * kl, d), rcfg.k_global,
                          iters=rcfg.kmeans_iters, n_init=rcfg.n_init,
                          weights=sizes.reshape(N * kl))
    return centroids


def fed_kmeans_router(gen, data, rcfg: RouterConfig, *, num_models=None,
                      client_mask=None) -> dict:
    """Algorithm 2. data: stacked padded client tensors (see federated.py);
    ``client_mask`` (N,) keeps only the eligible clients' uploads."""
    M = num_models if num_models is not None else rcfg.num_models
    centroids = fed_centroids(gen, data, rcfg, client_mask=client_mask)
    # (iii) clients → per-(cluster, model) stats; (iv) weighted aggregation
    a, c, n = _cluster_stats(centroids, data, rcfg.k_global, M)
    if client_mask is not None:
        m3 = _mask(client_mask, a)[:, None, None]
        a, c, n = a * m3, c * m3, n * m3
    a, c, n = a.sum(0), c.sum(0), n.sum(0)
    A, C = _finalize(a, c, n, rcfg.c_max)
    return {"centroids": centroids, "A": A, "C": C, "n": n}


def fed_kmeans_router_sharded(gen, data, rcfg: RouterConfig, *,
                              num_models=None, mesh=None) -> dict:
    """Algorithm 2 over a ``"clients"`` mesh: stage (i), the per-client
    local K-means, runs on each process's block of the stack (on the card
    through both K-means kernels); the (centroid, size) uploads and the
    per-(cluster, model) statistics return to the server stages through
    all-gathers in global client order (data movement only), and stages
    (ii) and (iv) run replicated with the in-process summation order.
    Stage (i)'s seeding draws are made over the whole stack
    (``sharding.ClientRows``), so the result equals ``fed_kmeans_router``
    on the same generator seed. ``data`` is the whole stack in every
    process or DTensors from ``sharding.shard_clients``."""
    M = num_models if num_models is not None else rcfg.num_models
    r, n = shd.clients_rank(mesh)
    local, N, _, whole = shd.local_block(data, mesh)
    if N % n != 0:
        raise ValueError(
            f"N={N} stacked clients do not divide the {n}-device "
            "clients mesh — pad the stack (federated.pad_client_axis) or "
            "resize the mesh")
    L = N // n
    if whole:
        local = {k: v[r * L:(r + 1) * L] for k, v in local.items()}
    d, kl, K = local["x"].shape[-1], rcfg.k_local, rcfg.k_global
    rows = gen if n == 1 else shd.ClientRows(
        gen, torch.arange(r * L, (r + 1) * L), N, L)
    cents_l, sizes_l = _local_uploads(rows, local, rcfg)
    up = shd.all_gather_rows(torch.cat([cents_l.reshape(L, kl * d), sizes_l],
                                       dim=1), mesh)
    # contiguous, as the in-process uploads are (the same reduction orders)
    cents, sizes = up[:, :kl * d].contiguous(), up[:, kl * d:].contiguous()
    # (ii) the server's K-means over the uploads, replicated
    centroids, _ = kmeans(gen, cents.reshape(N * kl, d), K,
                          iters=rcfg.kmeans_iters, n_init=rcfg.n_init,
                          weights=sizes.reshape(N * kl))
    # (iii) each process's clients' statistics; (iv) gathered, then summed
    # over the whole stack as in process
    s = shd.all_gather_rows(_cluster_sums(centroids, local, K, M), mesh)
    a, c, cnt = s[..., 1].sum(0), s[..., 2].sum(0), s[..., 0].sum(0)
    A, C = _finalize(a, c, cnt, rcfg.c_max)
    return {"centroids": centroids, "A": A, "C": C, "n": cnt}


def local_kmeans_router(gen, data_i, rcfg: RouterConfig, *, num_models=None,
                        k=None) -> dict:
    """Client-local (no-FL) baseline: own K-means + own statistics."""
    M = num_models if num_models is not None else rcfg.num_models
    K = k if k is not None else rcfg.k_local
    centroids, _ = kmeans(gen, data_i["x"], K, iters=rcfg.kmeans_iters,
                          n_init=rcfg.n_init, mask=data_i["w"] > 0)
    a, c, n = _cluster_stats(centroids, data_i, K, M)
    A, C = _finalize(a, c, n, rcfg.c_max)
    return {"centroids": centroids, "A": A, "C": C, "n": n}


def predict(router: dict, x: torch.Tensor):
    """x: (Q, d) → (A (Q,M), C (Q,M)) cluster-level estimates."""
    k = kops.kmeans_assign(x, router["centroids"]).long()
    return router["A"][k], router["C"][k]


# ---------------------------------------------------------------------------
# §6.3 model onboarding / App. D.3 client onboarding (training-free)
# ---------------------------------------------------------------------------


def add_model_stats(router: dict, calib, c_max: float = 1.0) -> dict:
    """Onboard one new model from calibration evaluations
    calib = {"x": (D,d), "acc": (D,), "cost": (D,), "w": (D,)}."""
    K = router["centroids"].shape[0]
    assign = kops.kmeans_assign(calib["x"], router["centroids"]).long()
    w = calib["w"].float()
    onehot = F.one_hot(assign, K).float()
    vals = torch.stack([w, w * calib["acc"], w * calib["cost"]], dim=-1)
    n, a, c = (onehot.T @ vals).unbind(-1)
    tot = torch.clamp(n.sum(), min=1e-12)
    ga, gc = a.sum() / tot, c.sum() / tot
    nn = torch.clamp(n, min=1e-12)
    A_new = torch.where(n > 0, a / nn, ga)
    C_new = torch.where(n > 0, c / nn, gc)
    return {
        "centroids": router["centroids"],
        "A": torch.cat([router["A"], A_new[:, None]], dim=1),
        "C": torch.cat([router["C"], C_new[:, None]], dim=1),
        "n": torch.cat([router["n"], n[:, None]], dim=1),
    }


def merge_client_stats(router: dict, data_new, rcfg: RouterConfig,
                       num_models=None) -> dict:
    """New clients join (App. D.3): weighted update of cluster statistics
    against the *existing* centers — no participation from old clients."""
    M = num_models if num_models is not None else rcfg.num_models
    K = router["centroids"].shape[0]
    a, c, n = _cluster_stats(router["centroids"], data_new, K, M)
    a, c, n = a.sum(0), c.sum(0), n.sum(0)
    # recover old sums from means × counts, then combine
    a_tot = router["A"] * router["n"] + a
    c_tot = router["C"] * router["n"] + c
    n_tot = router["n"] + n
    A, C = _finalize(a_tot, c_tot, n_tot, rcfg.c_max)
    return {"centroids": router["centroids"], "A": A, "C": C, "n": n_tot}
