"""Deterministic fault injection for the federation runtime (PyTorch
counterpart of ``repro/fed/faults.py``).

A ``FaultPlan`` is a frozen, seeded description of everything that can go
wrong between the clients and the server: clients dropping out of sync
rounds, straggling silos reporting stale updates, Byzantine clients
uploading corrupted updates or flipping their harvested outcome labels,
``report_outcome`` calls that never arrive, pool backends failing a
request, and the engine-level chaos of a traffic simulator (bursts, deadline
storms, cancels, page-pressure spikes). Every draw is a pure function of
``(seed, tags)`` — a crc32 of the tags, or numpy's ``default_rng`` for the
identity sets — so a faulted run replays exactly, and the draws equal the
reference's bit for bit.

Consumers:
  * traffic simulators call the predicates per event (``client_drops``,
    ``flip_label``, ``lose_outcome``, ``burst_size``, ...);
  * ``RoutedServer(fault_plan=...)`` consults ``backend_fails`` per submit
    attempt and retries or re-routes (``serve/gateway.py``);
  * the fit takes Byzantine clients as an aggregator wrapper,
    ``CorruptUpdates``, which corrupts the stacked client updates before
    any inner strategy aggregates them.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Tuple

import numpy as np
import torch

from repro_torch.fed.aggregators import (Aggregator, FedAvgAggregator,
                                         select_clients)
from repro_torch.train.optim import tree_map


def _unit(seed: int, *tags) -> float:
    """Deterministic uniform in [0, 1) from (seed, tags): crc32 of the
    repr, stable across processes and runs (unlike builtin ``hash``)."""
    h = zlib.crc32(repr((seed,) + tags).encode("utf-8"))
    return h / 2.0 ** 32


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded description of injected faults. All probabilities in [0, 1];
    the zero plan (all defaults) injects nothing."""

    seed: int = 0
    #: P(a client misses a given sync round) — participation churn.
    dropout: float = 0.0
    #: fraction of clients that straggle (their updates arrive stale).
    delay_frac: float = 0.0
    #: stragglers report 1..max_staleness syncs late.
    max_staleness: int = 4
    #: fraction of clients whose uploads are corrupted (stable identities).
    corrupt_frac: float = 0.0
    #: P(a corrupted client flips one harvested outcome label).
    label_flip: float = 0.0
    #: P(a report_outcome call is lost in transit).
    lose_outcomes: float = 0.0
    #: P(a pool backend fails one submit attempt).
    backend_fail: float = 0.0
    #: backends that are hard-down (every attempt fails).
    fail_models: Tuple[int, ...] = ()
    # --- engine-level chaos ---
    #: P(a traffic tick is a burst tick — burst_max arrivals at once).
    burst_rate: float = 0.0
    #: arrivals on a burst tick.
    burst_max: int = 8
    #: P(a window of storm_len ticks is a deadline storm — every arrival in
    #: the window carries storm_deadline).
    storm_rate: float = 0.0
    storm_len: int = 8
    #: deadline (engine steps) attached to storm-window arrivals.
    storm_deadline: int = 4
    #: P(a given request is cancelled mid-flight).
    cancel_rate: float = 0.0
    #: P(a tick suffers a page-pressure spike: the simulator scales that
    #: tick's arrivals' decode budgets by spike_scale).
    spike_rate: float = 0.0
    spike_scale: int = 4

    # ------------------------------------------------- client-side faults

    def client_drops(self, client: int, rnd: int) -> bool:
        """Does ``client`` miss sync round ``rnd``?"""
        return _unit(self.seed, "drop", int(client), int(rnd)) < self.dropout

    def corrupted_clients(self, n_clients: int) -> np.ndarray:
        """(n_clients,) bool — the stable Byzantine identity set:
        ⌊corrupt_frac·n⌋ clients drawn once per plan."""
        k = int(np.floor(self.corrupt_frac * n_clients))
        mask = np.zeros(n_clients, bool)
        if k > 0:
            rng = np.random.default_rng(self.seed * 1_000_003 + 0xBAD)
            mask[rng.choice(n_clients, size=k, replace=False)] = True
        return mask

    def straggler_clients(self, n_clients: int) -> np.ndarray:
        """(n_clients,) bool — the stable straggling-silo set."""
        k = int(np.floor(self.delay_frac * n_clients))
        mask = np.zeros(n_clients, bool)
        if k > 0:
            rng = np.random.default_rng(self.seed * 1_000_003 + 0x51_0)
            mask[rng.choice(n_clients, size=k, replace=False)] = True
        return mask

    def staleness(self, n_clients: int, sync: int) -> np.ndarray:
        """(n_clients,) int — syncs each client's update is late by at
        sync index ``sync``: 0 for healthy silos, 1..max_staleness for
        stragglers (per-sync draw, stable identities)."""
        out = np.zeros(n_clients, np.int64)
        for c in np.flatnonzero(self.straggler_clients(n_clients)):
            u = _unit(self.seed, "stale", int(c), int(sync))
            out[c] = 1 + int(u * self.max_staleness)
        return out

    def flip_label(self, client: int, event: int) -> bool:
        """Does a corrupted client flip the outcome label of its
        ``event``-th harvested observation? (Callers gate on membership in
        ``corrupted_clients``.)"""
        return _unit(self.seed, "flip", int(client),
                     int(event)) < self.label_flip

    def lose_outcome(self, rid: int) -> bool:
        """Is the report_outcome call for request ``rid`` lost?"""
        return _unit(self.seed, "lost", int(rid)) < self.lose_outcomes

    # ------------------------------------------------ server-side faults

    def backend_fails(self, m_idx: int, seq: int, attempt: int) -> bool:
        """Does backend ``m_idx`` fail attempt ``attempt`` of submission
        ``seq``? Hard-down backends (``fail_models``) always fail; others
        fail each attempt independently with ``backend_fail`` probability,
        so retries of transient faults can succeed."""
        if int(m_idx) in self.fail_models:
            return True
        return _unit(self.seed, "backend", int(m_idx), int(seq),
                     int(attempt)) < self.backend_fail

    # ------------------------------------------------ engine-level faults

    def burst_size(self, tick: int) -> int:
        """Arrivals injected at traffic tick ``tick`` on top of the
        simulator's own process: ``burst_max`` on a burst tick, else 0."""
        if _unit(self.seed, "burst", int(tick)) < self.burst_rate:
            return int(self.burst_max)
        return 0

    def deadline_storm(self, tick: int) -> bool:
        """Is ``tick`` inside a deadline-storm window? One draw per window
        of ``storm_len`` consecutive ticks."""
        window = int(tick) // max(int(self.storm_len), 1)
        return _unit(self.seed, "storm", window) < self.storm_rate

    def cancels_request(self, rid: int) -> bool:
        """Is request ``rid`` fated to be cancelled mid-flight?"""
        return _unit(self.seed, "cancel", int(rid)) < self.cancel_rate

    def cancel_after(self, rid: int, horizon: int) -> int:
        """Engine steps a fated request lives before its cancel lands:
        1..horizon, deterministic per rid."""
        u = _unit(self.seed, "cancel_at", int(rid))
        return 1 + int(u * max(int(horizon), 1))

    def page_spike(self, tick: int) -> int:
        """Decode-budget multiplier for arrivals at ``tick``:
        ``spike_scale`` on a page-pressure spike tick, else 1."""
        if _unit(self.seed, "spike", int(tick)) < self.spike_rate:
            return int(self.spike_scale)
        return 1

    # ------------------------------------------------------- fit wrapper

    def corrupt_updates(self, n_clients: int, inner: Aggregator = None, *,
                        mode: str = "sign_flip",
                        scale: float = 10.0) -> "CorruptUpdates":
        """The aggregator wrapper applying this plan's Byzantine set to a
        fit over ``n_clients`` stacked clients."""
        return CorruptUpdates(
            mask=tuple(bool(b) for b in self.corrupted_clients(n_clients)),
            inner=inner if inner is not None else FedAvgAggregator(),
            mode=mode, scale=scale)


@dataclasses.dataclass(frozen=True)
class CorruptUpdates(Aggregator):
    """Byzantine clients as an aggregator wrapper: corrupt the masked rows
    of the stacked client-update slab, then let the inner strategy
    aggregate what the server received.

    Modes: ``"sign_flip"`` uploads θ_prev − scale·(θ_i − θ_prev) (the
    honest delta reversed and amplified); ``"scaled_noise"`` adds
    ``scale``·N(0, 1) noise to the corrupted rows, drawn from the round's
    generator as one standard-normal tensor of each stacked leaf's shape,
    leaf by leaf in tree order, before the inner strategy runs. Clean rows
    pass through unchanged.

    The mask indexes the stacked client axis of the round: with ``cohort=``
    sampling, the cohort's positions. The round trains only its active
    clients, and ``select_clients`` gathers the mask with the same indices
    as the stack.
    """

    mask: Tuple[bool, ...] = ()
    inner: Aggregator = FedAvgAggregator()
    mode: str = "sign_flip"
    scale: float = 10.0

    @property
    def needs_prev(self) -> bool:
        # sign_flip reverses deltas against the round's input params;
        # declared for both modes, as in the reference
        return True

    @property
    def needs_staleness(self) -> bool:
        return getattr(self.inner, "needs_staleness", False)

    def _check(self, n: int) -> None:
        if self.mode not in ("sign_flip", "scaled_noise"):
            raise ValueError(f"unknown corruption mode {self.mode!r}")
        if len(self.mask) != n:
            raise ValueError(
                f"CorruptUpdates mask covers {len(self.mask)} clients but "
                f"the stacked update slab has {n} — build the wrapper with "
                f"corrupt_updates(n_clients={n})")

    def select_clients(self, idx, n):
        self._check(n)
        return dataclasses.replace(
            self, mask=tuple(self.mask[i] for i in idx.tolist()),
            inner=select_clients(self.inner, idx, n))

    def __call__(self, client_params, wts, gen, *, prev, staleness=None):
        self._check(int(wts.shape[0]))
        m = torch.tensor(self.mask, dtype=torch.bool, device=wts.device)

        def corrupt(s, p):
            s32 = s.float()
            if self.mode == "sign_flip":
                p32 = p.float()[None]
                bad = p32 - self.scale * (s32 - p32)
            else:
                bad = s32 + self.scale * torch.randn(
                    s.shape, generator=gen, device=s.device)
            rows = m.reshape((-1,) + (1,) * (s.ndim - 1))
            return torch.where(rows, bad, s32).to(s.dtype)

        corrupted = tree_map(corrupt, client_params, prev)
        extras = {}
        if getattr(self.inner, "needs_prev", False):
            extras["prev"] = prev
        if getattr(self.inner, "needs_staleness", False):
            extras["staleness"] = (staleness if staleness is not None
                                   else torch.zeros_like(wts))
        return self.inner(corrupted, wts, gen, **extras)
