"""Robustness scenarios: perturbed and adversarial queries (PyTorch
counterpart of ``repro/evalbench/perturb.py``).

Queries arrive as embeddings, so both scenarios act in embedding space:

  * ``paraphrase_drift`` — Gaussian jitter of the query embedding, the
    encoder-space effect of a meaning-preserving rewrite. Scoring keeps
    the query's true tables.
  * ``adversarial_queries`` — minimal interpolations toward a "donor"
    query that the router sends elsewhere, binary-searched to the decision
    boundary and kept only within a relative norm budget. Family-agnostic
    (needs only ``route``) and deterministic.

Both stay on the device of ``x``. The attack finds each query's nearest
donor in row blocks of a float64 distance matrix ‖x‖² − 2x·y + ‖y‖² (one
GEMM per block), never the reference's (Q, Q, d) difference tensor, which
at 9,005 rows of width 768 would take about 500 GB. The interpolation is
float64, and every ``route`` call gets it cast to float32 — the cast the
reference's JAX call makes implicitly.
"""
from __future__ import annotations

import torch

from repro_torch.device import generator

#: rows of the donor search's distance block: (block, Q) float64
DONOR_BLOCK = 2048


def paraphrase_drift(gen_or_noise, x, sigma: float):
    """x + σ·ε, ε ~ N(0, I): drawn on x's device from ``gen_or_noise`` (a
    generator there or an int seed), or ``gen_or_noise`` itself when it is
    a tensor of x's shape (a draw made elsewhere)."""
    x = torch.as_tensor(x)
    if isinstance(gen_or_noise, torch.Tensor):
        noise = gen_or_noise.to(x.device)
        if noise.shape != x.shape:
            raise ValueError(f"noise of shape {tuple(noise.shape)} for x of "
                             f"shape {tuple(x.shape)}")
    else:
        noise = torch.randn(x.shape, generator=generator(gen_or_noise,
                                                         x.device),
                            device=x.device, dtype=x.dtype)
    return x + sigma * noise


def nearest_donor(x: torch.Tensor, m: torch.Tensor, *,
                  block: int = DONOR_BLOCK) -> tuple:
    """For every row of x (Q, d), the nearest row routed elsewhere (m
    differs), first index on ties. Returns (donor (Q,) int64, has_donor
    (Q,) bool); a row with no donor gets donor 0 and has_donor False.
    Float64, one (block, Q) distance block at a time."""
    x = x.double()
    Q = x.shape[0]
    sq = (x * x).sum(1)
    donor = torch.empty(Q, dtype=torch.int64, device=x.device)
    has = torch.empty(Q, dtype=torch.bool, device=x.device)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=x.device)
    for i0 in range(0, Q, block):
        i1 = min(i0 + block, Q)
        d2 = sq[i0:i1, None] - 2.0 * (x[i0:i1] @ x.T) + sq[None, :]
        d2 = torch.where(m[i0:i1, None] == m[None, :], inf, d2)
        idx = torch.argmin(d2, dim=1)
        donor[i0:i1] = idx
        has[i0:i1] = torch.isfinite(d2.gather(1, idx[:, None])[:, 0])
    return donor, has


def adversarial_queries(router, x, lam: float, *, budget: float = 0.35,
                        steps: int = 10) -> tuple:
    """Adversarial routing-flip queries within a relative L2 budget.

    For every query, take the nearest donor query the router routes to a
    different model at the same λ, binary-search the smallest
    interpolation toward it that still flips the decision, and keep the
    perturbed query iff ‖δ‖ ≤ budget·‖x‖. Queries with no donor or over
    budget stay clean.

    Returns (x_adv (Q, d) float32 on x's device, {"flip_rate",
    "mean_rel_norm"}). Deterministic: only the router's own decision
    boundary is used."""
    x = torch.as_tensor(x).double()
    Q = x.shape[0]
    m0 = router.route(x.float(), lam)
    donor, has_donor = nearest_donor(x, m0)
    step_dir = x[donor] - x

    lo = torch.zeros(Q, dtype=torch.float64, device=x.device)
    hi = torch.ones(Q, dtype=torch.float64, device=x.device)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        xm = x + mid[:, None] * step_dir
        flips = router.route(xm.float(), lam) != m0
        hi = torch.where(flips, mid, hi)
        lo = torch.where(flips, lo, mid)

    delta = hi[:, None] * step_dir
    rel = torch.linalg.norm(delta, dim=1) / torch.clamp(
        torch.linalg.norm(x, dim=1), min=1e-12)
    keep = has_donor & (rel <= budget)
    x_adv = torch.where(keep[:, None], x + delta, x)
    flipped = keep & (router.route(x_adv.float(), lam) != m0)
    x_adv = torch.where(flipped[:, None], x_adv, x)
    n_flip = int(flipped.sum())
    return x_adv.float(), {
        "flip_rate": n_flip / Q,
        "mean_rel_norm": float(rel[flipped].mean()) if n_flip else 0.0,
    }
