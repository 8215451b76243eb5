"""Server-side aggregation strategies for the FedAvg round (PyTorch
counterpart of ``repro/fed/aggregators.py``, Alg. 1 line 11).

``core/federated.fedavg_round`` aggregates through one of these. Every
strategy implements

    aggregator(client_params, wts, gen) -> new_params

where ``client_params`` is the stacked (N-leading) client-update tree,
``wts`` the raw per-client aggregation weights (dataset sizes × the
round's active mask: 0 for a client that is not active) and ``gen`` the
round's ``torch.Generator``.

Strategies that need more than the stacked updates declare it:
``needs_prev = True`` makes ``fedavg_round`` pass ``prev=`` (the round's
input server params, for delta-based strategies) and ``needs_staleness =
True`` passes ``staleness=`` (per-client syncs since the client's data was
fresh, for buffered-async strategies). Plain three-argument strategies,
custom callables included, keep the three-argument call.

``GaussianDPAggregator`` wraps any inner strategy and forwards its
declared extras. The robust strategies are coordinate-wise over the
round's active clients (``wts > 0``) and ignore the dataset-size weights
on purpose: a corrupted client could inflate its weight as easily as its
update. Secure aggregation does not compose with them (the server learns
only the masked sum).

A strategy whose behaviour depends on a client's position in the stack
(``fed.faults.CorruptUpdates``) overrides ``select_clients``: the round
trains only its active clients and hands the strategy the compacted
stack, so position-indexed state is gathered with the same indices.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.core import secure_agg as SA
from repro_torch.train.optim import tree_leaves, tree_map


def _normalize(wts: torch.Tensor) -> torch.Tensor:
    return wts / torch.clamp(wts.sum(), min=1e-12)


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(N,) ``v`` shaped to broadcast over the rows of a stacked leaf."""
    return v.reshape((like.shape[0],) + (1,) * (like.ndim - 1))


def select_clients(agg, idx: torch.Tensor, n: int):
    """``agg`` restricted to positions ``idx`` of an ``n``-client stack
    (custom callables without ``select_clients`` are position-free)."""
    sel = getattr(agg, "select_clients", None)
    return agg if sel is None else sel(idx, n)


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """Base strategy; subclass and implement ``__call__``."""

    def __call__(self, client_params, wts, gen):
        raise NotImplementedError

    def select_clients(self, idx: torch.Tensor, n: int) -> "Aggregator":
        """This strategy for the sub-stack at positions ``idx`` of an
        ``n``-client round. Position-free strategies return themselves."""
        return self


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
            upload = s.float() + _rows(inv, s) * m
            return torch.tensordot(wn, upload, dims=1).to(s.dtype)

        return tree_map(leaf, client_params, net_stack)


@dataclasses.dataclass(frozen=True)
class GaussianDPAggregator(Aggregator):
    """Server-side Gaussian noise N(0, σ²) on the aggregate of an inner
    strategy (the central-DP flavour of the paper's privacy motivation).
    Forwards the inner strategy's declared extras; the noise is drawn from
    ``gen`` after the inner strategy ran, one draw per leaf in leaf
    order."""

    sigma: float = 0.0
    inner: Aggregator = FedAvgAggregator()

    @property
    def needs_prev(self) -> bool:
        return getattr(self.inner, "needs_prev", False)

    @property
    def needs_staleness(self) -> bool:
        return getattr(self.inner, "needs_staleness", False)

    def select_clients(self, idx, n):
        return dataclasses.replace(
            self, inner=select_clients(self.inner, idx, n))

    def __call__(self, client_params, wts, gen, **extras):
        out = self.inner(client_params, wts, gen, **extras)
        if self.sigma <= 0.0:
            return out
        return tree_map(lambda l: l + self.sigma * torch.randn(
            l.shape, generator=gen, device=l.device, dtype=l.dtype), out)


# ---------------------------------------------------------------------------
# Byzantine-robust strategies: coordinate-wise and unweighted over the
# round's active clients.
# ---------------------------------------------------------------------------


def _sorted_active(leaf: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The stacked leaf sorted along the client axis with inactive rows as
    +inf: the round's n_act real updates hold ranks [0, n_act) in
    ascending order, coordinate by coordinate."""
    masked = torch.where(_rows(active, leaf) > 0, leaf.float(), torch.inf)
    return torch.sort(masked, dim=0).values


def _ranks_like(leaf: torch.Tensor) -> torch.Tensor:
    return _rows(torch.arange(leaf.shape[0], device=leaf.device), leaf)


def _delta_norm_scale(deltas, clip: float) -> torch.Tensor:
    """(N,) min(1, clip / ‖δ_i‖), the global L2 norm over every leaf."""
    sq = sum((d * d).sum(dim=tuple(range(1, d.ndim)))
             for d in tree_leaves(deltas))
    return torch.clamp(clip / torch.clamp(torch.sqrt(sq), min=1e-12),
                       max=1.0)


def _deltas(client_params, prev):
    return tree_map(lambda s, p: s.float() - p.float()[None],
                    client_params, prev)


@dataclasses.dataclass(frozen=True)
class TrimmedMeanAggregator(Aggregator):
    """Coordinate-wise trimmed mean (Yin et al. 2018): per coordinate, sort
    the active clients' values, drop the k smallest and k largest with
    k = min(⌊trim_frac·n_act⌋, ⌈n_act/2⌉ − 1), and average the rest, so at
    least one value survives."""

    trim_frac: float = 0.25

    def __call__(self, client_params, wts, gen):
        active = (wts > 0).float()
        n_act = torch.clamp(active.sum(), min=1.0)
        k = torch.minimum(torch.floor(self.trim_frac * n_act),
                          torch.ceil(n_act / 2.0) - 1.0)

        def leaf(s):
            srt = _sorted_active(s, active)
            r = _ranks_like(s)
            keep = (r >= k) & (r < n_act - k)
            total = torch.where(keep, srt, 0.0).sum(dim=0)
            return (total / torch.clamp(n_act - 2.0 * k, min=1.0)).to(
                s.dtype)

        return tree_map(leaf, client_params)


@dataclasses.dataclass(frozen=True)
class MedianAggregator(Aggregator):
    """Coordinate-wise median over the round's active clients: the mean of
    the order statistics at ranks ⌊(n_act−1)/2⌋ and ⌊n_act/2⌋ (for an
    even n_act the mean of the two middle values, where ``torch.median``
    would give the lower one)."""

    def __call__(self, client_params, wts, gen):
        active = (wts > 0).float()
        n_act = torch.clamp(active.sum(), min=1.0).to(torch.int64)
        lo = ((n_act - 1) // 2).reshape(1)
        hi = (n_act // 2).reshape(1)

        def leaf(s):
            srt = _sorted_active(s, active)
            med = 0.5 * (srt.index_select(0, lo)[0]
                         + srt.index_select(0, hi)[0])
            return med.to(s.dtype)

        return tree_map(leaf, client_params)


@dataclasses.dataclass(frozen=True)
class NormClipAggregator(Aggregator):
    """Weighted FedAvg over norm-clipped client deltas: each update becomes
    θ_i − θ_prev, clipped to global L2 norm ≤ ``clip`` over all leaves,
    averaged and re-applied to θ_prev. Bounds any one client's pull on the
    aggregate."""

    clip: float = 1.0
    needs_prev: ClassVar[bool] = True

    def __call__(self, client_params, wts, gen, *, prev):
        wn = _normalize(wts.float())
        deltas = _deltas(client_params, prev)
        scale = _delta_norm_scale(deltas, self.clip)

        def leaf(d, p):
            agg = torch.tensordot(wn, d * _rows(scale, d), dims=1)
            return (p.float() + agg).to(p.dtype)

        return tree_map(leaf, deltas, prev)


@dataclasses.dataclass(frozen=True)
class BufferedAsyncAggregator(Aggregator):
    """FedBuffer-style buffered-async aggregation (Nguyen et al. 2022):
    each client's delta is down-weighted by (1 + s_i)^(−staleness_alpha),
    s_i the syncs since its data was fresh; ``server_lr`` scales the
    aggregate step, and ``clip > 0`` also norm-clips each delta. With zero
    staleness and ``server_lr=1`` this is weighted FedAvg in delta form."""

    server_lr: float = 1.0
    staleness_alpha: float = 0.5
    clip: float = 0.0
    needs_prev: ClassVar[bool] = True
    needs_staleness: ClassVar[bool] = True

    def __call__(self, client_params, wts, gen, *, prev, staleness):
        decay = (1.0 + torch.clamp(staleness.float(), min=0.0)) ** (
            -self.staleness_alpha)
        wn = _normalize(wts.float() * decay)
        deltas = _deltas(client_params, prev)
        scale = (_delta_norm_scale(deltas, self.clip) if self.clip > 0.0
                 else torch.ones_like(wn))

        def leaf(d, p):
            agg = torch.tensordot(wn, d * _rows(scale, d), dims=1)
            return (p.float() + self.server_lr * agg).to(p.dtype)

        return tree_map(leaf, deltas, prev)
