"""Server-side aggregation strategies for the FedAvg round (PyTorch
counterpart of ``repro/fed/aggregators.py``, Alg. 1 line 11).

``core/federated.fedavg_round`` aggregates through one of these. Every
strategy implements

    aggregator(client_params, wts, gen) -> new_params

where ``client_params`` is the stacked (N-leading) client-update tree,
``wts`` the raw per-client aggregation weights (dataset sizes × the
round's active mask) and ``gen`` the round's ``torch.Generator``.

Ported: plain weighted FedAvg and central-DP Gaussian noise over it, the
default strategy of ``fedavg_round``. Secure aggregation and the robust
and buffered-async strategies are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

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
