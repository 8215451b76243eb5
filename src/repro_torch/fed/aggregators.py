"""Server-side aggregation strategies for the FedAvg round (PyTorch
counterpart of ``repro/fed/aggregators.py``, Alg. 1 line 11).

``core/federated.fedavg_round`` aggregates through one of these. Every
strategy implements

    aggregator(client_params, wts, gen) -> new_params

where ``client_params`` is the stacked (N-leading) client-update tree,
``wts`` the raw per-client aggregation weights (dataset sizes × the
round's active mask) and ``gen`` the round's ``torch.Generator``.

Ported: plain weighted FedAvg, pairwise-masked secure aggregation, and
central-DP Gaussian noise over either. The robust and buffered-async
strategies are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import secure_agg as SA
from repro_torch.train.optim import tree_map


def _normalize(wts: torch.Tensor) -> torch.Tensor:
    return wts / torch.clamp(wts.sum(), min=1e-12)


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """Base strategy; subclass and implement ``__call__``."""

    def __call__(self, client_params, wts, gen):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FedAvgAggregator(Aggregator):
    """Plain weighted FedAvg: normalize, f32 contraction over the client
    axis, cast back."""

    def __call__(self, client_params, wts, gen):
        wn = _normalize(wts.float())
        return tree_map(
            lambda s: torch.tensordot(wn, s.float(), dims=1).to(s.dtype),
            client_params)


@dataclasses.dataclass(frozen=True)
class SecureAggAggregator(Aggregator):
    """Pairwise-masked FedAvg (Bonawitz et al. 2016, via
    ``core/secure_agg``): every pair of round participants derives a shared
    mask from the round's seed; each client folds its pair masks (+ below
    the partner's index, − above) into its upload, so the server's
    weighted sum carries every mask once with each sign and learns only
    the aggregate.

    Masks are gated by the participant set (``wts > 0``), and client i
    uploads θ_i + net_i / w̃_i, so the server's reduction is the same
    contraction as ``FedAvgAggregator``: with ``scale=0`` the masks are
    exact zeros and the result is bit-identical to plain FedAvg; with
    ``scale>0`` they cancel to float rounding (~1e-6·scale per parameter).
    The round's seed is drawn from a copy of ``gen`` (``round_seed``), so
    the fit's own stream is what an unmasked fit draws."""

    scale: float = 10.0

    def __call__(self, client_params, wts, gen):
        N = int(wts.shape[0])
        wn = _normalize(wts.float())
        active = [bool(a) for a in (wts > 0).tolist()]  # the participants
        nets = [tree_map(lambda s: torch.zeros(s.shape[1:], device=s.device),
                         client_params) for _ in range(N)]
        seed = SA.round_seed(gen)
        dev = wts.device
        for i in range(N):
            for j in range(i + 1, N):
                if not (active[i] and active[j]):
                    continue
                m = SA.mask_like(SA.pair_generator(seed, i, j, dev),
                                 nets[i], self.scale)
                nets[i] = tree_map(torch.add, nets[i], m)
                nets[j] = tree_map(torch.sub, nets[j], m)
        inv = torch.where(wn > 0, 1.0 / torch.clamp(wn, min=1e-30), 0.0)
        net_stack = tree_map(lambda *ls: torch.stack(ls), *nets)

        def leaf(s, m):
            shape = (N,) + (1,) * (s.ndim - 1)
            upload = s.float() + inv.reshape(shape) * m
            return torch.tensordot(wn, upload, dims=1).to(s.dtype)

        return tree_map(leaf, client_params, net_stack)


@dataclasses.dataclass(frozen=True)
class GaussianDPAggregator(Aggregator):
    """Server-side Gaussian noise N(0, σ²) on the aggregate of an inner
    strategy (the central-DP flavour of the paper's privacy motivation)."""

    sigma: float = 0.0
    inner: Aggregator = FedAvgAggregator()

    def __call__(self, client_params, wts, gen):
        out = self.inner(client_params, wts, gen)
        if self.sigma <= 0.0:
            return out
        return tree_map(lambda l: l + self.sigma * torch.randn(
            l.shape, generator=gen, device=l.device, dtype=l.dtype), out)
