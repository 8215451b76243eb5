"""Unified fitting entry points for every router family (PyTorch
counterpart of ``repro/routers/fit.py``).

``fit_federated`` dispatches to iterative FedAvg rounds (Alg. 1) for
parametric routers and to the one-shot statistics protocol (Alg. 2) for
nonparametric ones; both return ``(router, history)`` with
``history = {"loss": [...], "eval": [...]}``. ``fit_local`` is the no-FL
baseline (client-local or, on pooled data, centralized).

Both run on the CUDA device unless ``device`` names another (without a
GPU and without ``device="cpu"`` they raise). The data (tensors or numpy
arrays) is moved there, and ``gen`` is a generator on that device or an
int seed.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.config import FedConfig
from repro_torch.device import (DeviceLike, generator, on_device,
                                resolve_device)
from repro_torch.routers.base import Router


def _normalize_hist(hist: dict) -> dict:
    hist.setdefault("loss", [])
    hist.setdefault("eval", [])
    return hist


def fit_federated(router: Router, data: dict, fcfg: FedConfig, *, gen,
                  rounds: Optional[int] = None,
                  eval_fn: Optional[Callable[[Router], object]] = None,
                  mesh=None, device: DeviceLike = None,
                  **family_kw) -> tuple[Router, dict]:
    """Fit ``router`` on stacked, padded client data (see
    ``core/federated.py`` for the layout). Returns a NEW fitted router plus
    the history dict. ``eval_fn`` receives a fitted ``Router`` (per round
    for iterative families, once for one-shot families); ``family_kw``
    forwards family-specific knobs (optimizer=, full_batch=, freeze=,
    distill=, client_mask=, dp_sigma=, aggregator=, cohort=, staleness=,
    eval_every=); the one-shot families refuse what they do not take."""
    dev = resolve_device(device)
    new_router, hist = router._fit_federated(
        generator(gen, dev), on_device(data, dev), fcfg, rounds=rounds,
        eval_fn=eval_fn, mesh=mesh, **family_kw)
    return new_router, _normalize_hist(hist)


def fit_local(router: Router, data_i: dict, fcfg: FedConfig, *, gen,
              device: DeviceLike = None, **family_kw) -> tuple[Router, dict]:
    """No-FL baseline on one flat dataset {"x","m","acc","cost","w"}:
    minibatch ERM for parametric families (steps=, optimizer=), local
    K-means + own statistics for nonparametric ones (k=)."""
    dev = resolve_device(device)
    new_router, hist = router._fit_local(generator(gen, dev),
                                         on_device(data_i, dev),
                                         fcfg, **family_kw)
    return new_router, _normalize_hist(hist)
