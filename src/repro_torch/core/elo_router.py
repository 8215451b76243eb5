"""Similarity-weighted Elo/ranking router — nonparametric, one-shot
(PyTorch counterpart of ``repro/core/elo_router.py``; Alg. 2).

Anchors come from the same two-stage federated K-means as the
K-Means-Router (``kmeans_router.fed_centroids``). Each client then
uploads, per (anchor k, model m), similarity-weighted evaluation sums

    n[k,m] = Σ_i s_k(x_i) · w_i · 1[m_i = m]
    a[k,m] = Σ_i s_k(x_i) · w_i · acc_i · 1[m_i = m]
    c[k,m] = Σ_i s_k(x_i) · w_i · cost_i · 1[m_i = m]

where s_k(x) is a softmax similarity kernel over anchors. The sums are
linear in the samples, so the server's aggregation is plain addition — the
one-shot statistics protocol of Alg. 2 with soft anchor assignment.

The server turns shrunk win-rates into Elo-style ratings,

    R[k,m] = s_elo · logit(p̃),  p̃ = (a + n0·p_glob[m]) / (n + n0),

and inference interpolates in rating space: A = σ(s·R / s_elo), C = s·C.

State θ = {"anchors" (K,d), "rating" (K,M), "C" (K,M), raw sums
"a"/"c"/"n" (K,M), "tau" ()}, in the reference's key order (checkpoints
are byte-compatible). Raw sums are kept so onboarding merges stay exact.
Every function also takes clients stacked along a leading axis.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import RouterConfig
from repro_torch.core.kmeans import kmeans
from repro_torch.core.kmeans_router import _mask, fed_centroids

# classic Elo logistic scale: 400 rating points per decade of odds
ELO_SCALE = 400.0 / math.log(10.0)
_P_CLIP = 1e-3


def _tau(rcfg: RouterConfig) -> float:
    """Kernel bandwidth. Squared distances between unit-scale embeddings
    grow linearly with d, so the config knob is in units of sqrt(d_emb)."""
    return rcfg.elo_tau * math.sqrt(rcfg.d_emb)


def kernel_weights(x: torch.Tensor, anchors: torch.Tensor,
                   tau) -> torch.Tensor:
    """Softmax similarity kernel s_k(x) over anchors: (…, Q, d) → (…, Q, K).
    The squared distance is the reference's f32 expansion
    ‖x‖² + ‖a‖² − 2x·a (``torch.cdist`` rounds otherwise, and the softmax is
    nearly one-hot at the default bandwidth, so the difference would show)."""
    x, anchors = x.float(), anchors.float()
    d2 = ((x * x).sum(-1)[..., None] + (anchors * anchors).sum(-1)
          - 2.0 * torch.matmul(x, anchors.T))
    return torch.softmax(-d2 / (2.0 * tau * tau), dim=-1)


def _anchor_stats(anchors, data, M: int, tau):
    """Similarity-weighted sums (a, c, n) per (anchor, model) for one
    client (flat data, (K, M) each) or each client of a stack ((N, K, M))
    — linear in the samples, hence one-shot aggregable (Alg. 2 9–12)."""
    s = kernel_weights(data["x"], anchors, tau)               # (…, D, K)
    swT = (s * data["w"].float()[..., None]).transpose(-1, -2)
    onehot = F.one_hot(data["m"].long(), M).float()           # (…, D, M)
    n = torch.matmul(swT, onehot)
    a = torch.matmul(swT, onehot * data["acc"].float()[..., None])
    c = torch.matmul(swT, onehot * data["cost"].float()[..., None])
    return a, c, n


def _finalize(a_sum, c_sum, n, rcfg: RouterConfig):
    """Aggregate sums → per-anchor ratings + cost estimates, with
    pseudo-count shrinkage toward each model's global mean (a model never
    observed anywhere backs off to the pessimistic (acc 0, cost c_max))."""
    n0 = max(rcfg.elo_prior, 1e-6)
    tot_n = n.sum(0)                                          # (M,)
    safe = torch.clamp(tot_n, min=1e-12)
    p_glob = torch.where(tot_n > 0, a_sum.sum(0) / safe, 0.0)
    c_glob = torch.where(tot_n > 0, c_sum.sum(0) / safe, rcfg.c_max)
    p = (a_sum + n0 * p_glob[None, :]) / (n + n0)
    p = torch.clamp(p, _P_CLIP, 1.0 - _P_CLIP)
    rating = ELO_SCALE * (torch.log(p) - torch.log1p(-p))
    C = (c_sum + n0 * c_glob[None, :]) / (n + n0)
    return rating, C


def _build_state(anchors, a, c, n, rcfg: RouterConfig) -> dict:
    rating, C = _finalize(a, c, n, rcfg)
    return {"anchors": anchors, "rating": rating, "C": C, "a": a, "c": c,
            "n": n, "tau": torch.tensor(_tau(rcfg), dtype=torch.float32,
                                        device=anchors.device)}


def fed_elo_router(gen, data, rcfg: RouterConfig, *, num_models=None,
                   client_mask=None) -> dict:
    """One-shot federated fit. data: stacked padded client tensors (see
    federated.py); ``client_mask`` (N,) keeps only eligible clients'
    uploads."""
    M = num_models if num_models is not None else rcfg.num_models
    anchors = fed_centroids(gen, data, rcfg, client_mask=client_mask)
    a, c, n = _anchor_stats(anchors, data, M, _tau(rcfg))
    if client_mask is not None:
        m3 = _mask(client_mask, a)[:, None, None]
        a, c, n = a * m3, c * m3, n * m3
    return _build_state(anchors, a.sum(0), c.sum(0), n.sum(0), rcfg)


def local_elo_router(gen, data_i, rcfg: RouterConfig, *, num_models=None,
                     k=None) -> dict:
    """Client-local (no-FL) baseline: own K-means anchors + own ratings."""
    M = num_models if num_models is not None else rcfg.num_models
    K = k if k is not None else rcfg.k_local
    anchors, _ = kmeans(gen, data_i["x"], K, iters=rcfg.kmeans_iters,
                        n_init=rcfg.n_init, mask=data_i["w"] > 0)
    a, c, n = _anchor_stats(anchors, data_i, M, _tau(rcfg))
    return _build_state(anchors, a, c, n, rcfg)


def predict(router: dict, x: torch.Tensor):
    """x: (Q, d) → (A (Q,M) in [0,1], C (Q,M)): similarity-weighted rating
    interpolation, mapped back through the logistic link."""
    s = kernel_weights(x, router["anchors"], router["tau"])   # (Q, K)
    A = torch.sigmoid((s @ router["rating"]) / ELO_SCALE)
    return A, s @ router["C"]


def prior_state(gen: torch.Generator, rcfg: RouterConfig, *,
                num_models=None) -> dict:
    """An uninformative cold-start state on the generator's device: random
    anchors, near-flat ratings (a ±~10-point jitter, so the cold-start
    argmax does not send all traffic to model 0), mid-scale costs, zero
    counts. Shapes match any fitted state with the same (k_global, M)."""
    M = num_models if num_models is not None else rcfg.num_models
    K, dev = rcfg.k_global, gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    anchors = normal(K, rcfg.d_emb)
    z = torch.zeros((K, M), device=dev)
    rating = 10.0 * normal(K, M)
    C = torch.clamp(rcfg.c_max / 2.0 * (1.0 + 0.05 * normal(K, M)), 0.0,
                    rcfg.c_max)
    return {"anchors": anchors, "rating": rating, "C": C, "a": z,
            "c": z.clone(), "n": z.clone(),
            "tau": torch.tensor(_tau(rcfg), dtype=torch.float32, device=dev)}


# ---------------------------------------------------------------------------
# §6.3 model onboarding / App. D.3 client onboarding (training-free)
# ---------------------------------------------------------------------------


def add_model_stats(router: dict, calib, rcfg: RouterConfig) -> dict:
    """Onboard one new model from calibration evaluations
    calib = {"x": (D,d), "acc": (D,), "cost": (D,), "w": (D,)}: append its
    similarity-weighted sums as a new column and re-finalize the ratings."""
    s = kernel_weights(calib["x"], router["anchors"], router["tau"])
    sw = s * calib["w"].float()[:, None]                      # (D, K)
    n_new = sw.sum(0)                                         # (K,)
    a_new = (sw * calib["acc"].float()[:, None]).sum(0)
    c_new = (sw * calib["cost"].float()[:, None]).sum(0)
    a = torch.cat([router["a"], a_new[:, None]], dim=1)
    c = torch.cat([router["c"], c_new[:, None]], dim=1)
    n = torch.cat([router["n"], n_new[:, None]], dim=1)
    return _build_state(router["anchors"], a, c, n, rcfg)


def merge_client_stats(router: dict, data_new, rcfg: RouterConfig,
                       num_models=None) -> dict:
    """New clients join (App. D.3): add their similarity-weighted sums
    against the *existing* anchors — exact, because the state keeps raw
    sums rather than only the finalized ratings."""
    M = num_models if num_models is not None else rcfg.num_models
    a, c, n = _anchor_stats(router["anchors"], data_new, M, router["tau"])
    return _build_state(router["anchors"], router["a"] + a.sum(0),
                        router["c"] + c.sum(0), router["n"] + n.sum(0), rcfg)
