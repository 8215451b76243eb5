"""Federated MLP-Router training (PyTorch counterpart of
``repro/core/federated.py``; paper Algorithm 1 + Appendix C.1).

Clients are simulated as stacked, padded tensors. The clients of a round
train together: their params are stacked along a leading client axis, one
batched forward and backward pass (batched matmuls, autograd on the
stack) serves them all, and the optimizer keeps one step count per client.
Per client, as in the reference:

  * the gradient clip's global norm is taken over that client's tree;
  * steps past the client's ⌈D_i/batch⌉ keep its params AND its optimizer
    state, so its bias correction does not advance;
  * minibatch rows are drawn with replacement from [0, D_i).

Only the round's active clients train: an inactive client's update has
aggregation weight 0, so leaving it out changes no result.

Client dataset layout (N clients, padded to D_max rows):
  {"x": (N, D, d_emb), "m": (N, D) int32, "acc": (N, D), "cost": (N, D),
   "w": (N, D) ∈ {0,1} valid-row mask}

The family's loss (``loss_fn``), a freeze mask (§6.3 model onboarding),
the distillation anchor and the eligible-client mask (App. D.3 client
onboarding) apply as in the reference. Not ported yet, each raising
``NotImplementedError``: the sharded round (``mesh=``,
``fedavg_round_sharded``, ``pad_client_axis``), cohort sampling and
``staleness``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.config import FedConfig, RouterConfig
from repro_torch.core import mlp_router as R
from repro_torch.fed.aggregators import FedAvgAggregator, GaussianDPAggregator
from repro_torch.train.optim import (SGD, AdamW, AdamWState, masked_update,
                                     tree_leaves, tree_map)


def _not_ported(**knobs) -> None:
    for name, val in knobs.items():
        if val is not None:
            raise NotImplementedError(
                f"{name}= is not ported to the PyTorch fit yet")


def dataset_sizes(data) -> torch.Tensor:
    return data["w"].sum(dim=-1)  # (N,)


def _make_opt(fcfg: FedConfig, optimizer: str):
    if optimizer == "adamw":
        return AdamW(lr=fcfg.lr, weight_decay=fcfg.weight_decay,
                     clip_norm=fcfg.clip_norm)
    if optimizer == "sgd":
        return SGD(lr=fcfg.lr, clip_norm=None)
    raise ValueError(optimizer)


def _distill_loss(params, theta0, x, w, apply_fn=None):
    """App. D.3 regularizer: match the frozen base router's predictions,
    per client. ``apply_fn(params, x) -> (A, C)`` selects the family's
    forward pass (default: the MLP router); ``theta0`` is unstacked."""
    apply_fn = apply_fn if apply_fn is not None else R.apply_mlp_router
    A, C = apply_fn(params, x)
    A0, C0 = apply_fn(theta0, x)
    per = ((A - A0) ** 2 + (C - C0) ** 2).mean(dim=-1)   # mean over models
    return (per * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)


def _family_loss(loss_fn, distill):
    """The per-client training loss: the family's (default: the MLP
    router's Eq. 3) plus β times the distillation term when ``distill`` is
    ``(theta0, beta)`` or ``(theta0, beta, apply_fn)``."""
    base = loss_fn if loss_fn is not None else R.router_loss
    if distill is None:
        return base
    theta0, beta = distill[0], distill[1]
    apply_fn = distill[2] if len(distill) > 2 else None

    def loss(p, batch, rcfg, *, gen=None):
        w = batch.get("w")
        if w is None:
            w = torch.ones(batch["x"].shape[:-1], device=batch["x"].device)
        return base(p, batch, rcfg, gen=gen) + beta * _distill_loss(
            p, theta0, batch["x"], w, apply_fn)
    return loss


def _select(active: torch.Tensor, new, old):
    """Per client: ``new`` where ``active``, else ``old`` (trees, or an
    optimizer state, with a leading client axis)."""
    def sel(n, o):
        return torch.where(active.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)
    if isinstance(old, AdamWState):
        return AdamWState(*(tree_map(sel, n, o) for n, o in zip(new, old)))
    return tree_map(sel, new, old)


def _local_steps(params, data, gen, rcfg: RouterConfig, fcfg: FedConfig, opt,
                 steps: int, n_steps: torch.Tensor, *, full_batch: bool,
                 loss_fn=None, freeze=None):
    """``steps`` optimizer steps on a stack of clients: params (N, ...),
    data (N, D, ...). Client i updates on its first ``n_steps[i]`` steps
    only. ``loss_fn(params, batch, rcfg, gen=)`` gives one loss per client
    of the stack (default: the MLP router's); ``freeze`` masks the steps
    (``optim.masked_update``). Returns (params, losses (steps, N))."""
    loss_fn = loss_fn if loss_fn is not None else R.router_loss
    N = data["x"].shape[0]
    dev = data["x"].device
    D = dataset_sizes(data).to(torch.int64)
    rows = torch.arange(N, device=dev)[:, None]
    state = opt.init(params, batch=N)
    losses = []
    for s in range(steps):
        if full_batch:
            batch, g = data, None
        else:
            hi = torch.clamp(D, min=1)
            u = torch.rand((N, fcfg.batch_size), generator=gen, device=dev,
                           dtype=torch.float64)
            idx = torch.minimum((u * hi[:, None]).long(), hi[:, None] - 1)
            batch = {k: v[rows, idx] for k, v in data.items()}
            g = gen
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = loss_fn(p, batch, rcfg, gen=g)                # (N,)
        grads = iter(torch.autograd.grad(loss.sum(), tree_leaves(p)))
        grads = tree_map(lambda _: next(grads), params)
        new_params, new_state = masked_update(opt, grads, state, params,
                                              freeze)
        active = s < n_steps
        params = _select(active, new_params, params)
        state = _select(active, new_state, state)
        losses.append(loss.detach())
    return params, torch.stack(losses)


def client_update(params, data, gen, rcfg: RouterConfig, fcfg: FedConfig,
                  opt, max_steps: int, *, full_batch: bool = False,
                  freeze=None, distill=None, loss_fn=None):
    """τ local steps (≈1 epoch: ⌈D_i/batch⌉ active steps) on each client of
    the stack ``data``, all starting from the server ``params``.
    ``loss_fn`` selects the family's loss (None: the MLP router's),
    ``distill`` is ``(theta0, beta)`` or ``(theta0, beta, apply_fn)`` and
    ``freeze`` a 0/1 mask tree like ``params``. Returns (stacked client
    params, (N,) mean loss over the ``max_steps`` steps)."""
    N = data["x"].shape[0]
    stacked = tree_map(lambda t: t.expand((N,) + t.shape).clone(), params)
    D = dataset_sizes(data)
    n_steps = torch.ceil(D / fcfg.batch_size).to(torch.int64)
    stacked, losses = _local_steps(stacked, data, gen, rcfg, fcfg, opt,
                                   max_steps, n_steps, full_batch=full_batch,
                                   loss_fn=_family_loss(loss_fn, distill),
                                   freeze=freeze)
    return stacked, losses.mean(dim=0)


def _default_aggregator(dp_sigma: float):
    if dp_sigma > 0.0:
        return GaussianDPAggregator(sigma=dp_sigma)
    return FedAvgAggregator()


def fedavg_round(params, data, gen, rcfg: RouterConfig, fcfg: FedConfig,
                 opt, max_steps: int, *, full_batch: bool = False,
                 freeze=None, distill=None, client_mask=None,
                 dp_sigma: float = 0.0, aggregator=None, loss_fn=None):
    """One communication round: local updates on the active clients and
    the server aggregation (Alg. 1 lines 3–11). round(participation·N)
    clients are drawn by a permutation; ``client_mask`` (N,) restricts
    them to the eligible pool, and when none of the drawn ones is eligible
    the whole pool trains (App. D.3). The aggregation weights are the
    active clients' dataset sizes. dp_sigma > 0 adds server-side Gaussian
    noise over whichever strategy runs."""
    N = data["x"].shape[0]
    dev = data["x"].device
    n_active = max(1, int(round(fcfg.participation * N)))
    drawn = torch.randperm(N, generator=gen, device=dev)[:n_active]
    active = torch.zeros(N, device=dev)
    active[drawn] = 1.0
    if client_mask is not None:
        mask = torch.as_tensor(client_mask, dtype=torch.float32, device=dev)
        active = active * mask
        if float(active.sum()) <= 0:
            active = mask
    idx = torch.nonzero(active).reshape(-1)
    sub = {k: v[idx] for k, v in data.items()}
    client_params, client_loss = client_update(
        params, sub, gen, rcfg, fcfg, opt, max_steps, full_batch=full_batch,
        freeze=freeze, distill=distill, loss_fn=loss_fn)
    wts = dataset_sizes(sub) * active[idx]
    if aggregator is None:
        agg = _default_aggregator(dp_sigma)
    elif dp_sigma > 0.0:
        agg = GaussianDPAggregator(sigma=dp_sigma, inner=aggregator)
    else:
        agg = aggregator
    new_params = agg(client_params, wts, gen)
    wn = wts / torch.clamp(wts.sum(), min=1e-12)
    return new_params, (client_loss * wn).sum()


def fedavg_round_sharded(*args, **kwargs):
    raise NotImplementedError(
        "fedavg_round_sharded (the client mesh) is not ported to the "
        "PyTorch fit yet")


def pad_client_axis(*args, **kwargs):
    raise NotImplementedError(
        "pad_client_axis (for the client mesh) is not ported to the "
        "PyTorch fit yet")


def fedavg(gen, data, rcfg: RouterConfig, fcfg: FedConfig, *,
           rounds: Optional[int] = None, optimizer: str = "adamw",
           init=None, full_batch: bool = False,
           dp_sigma: float = 0.0, aggregator=None,
           eval_fn: Optional[Callable] = None, eval_every: int = 1,
           freeze=None, distill=None, loss_fn=None, cohort=None,
           staleness=None, mesh=None, client_mask=None):
    """Run T rounds of Algorithm 1 from ``init`` (or a fresh MLP router
    drawn from ``gen``). ``loss_fn`` selects the family's loss, ``freeze``
    masks the steps, ``distill`` anchors them to a frozen router and
    ``client_mask`` restricts each round to eligible clients (see
    ``fedavg_round``). Returns (params, {"loss": per-round loss, "eval":
    ``eval_fn(params)`` after every ``eval_every`` rounds and after the
    last})."""
    _not_ported(mesh=mesh, cohort=cohort, staleness=staleness)
    rounds = rounds if rounds is not None else fcfg.rounds
    D_max = data["x"].shape[1]
    max_steps = 1 if full_batch else max(
        1, math.ceil(D_max / fcfg.batch_size)) * fcfg.local_epochs
    params = init if init is not None else R.init_mlp_router(gen, rcfg)
    opt = _make_opt(fcfg, optimizer)
    hist = {"loss": [], "eval": []}
    for t in range(rounds):
        params, loss = fedavg_round(params, data, gen, rcfg, fcfg, opt,
                                    max_steps, full_batch=full_batch,
                                    freeze=freeze, distill=distill,
                                    client_mask=client_mask,
                                    dp_sigma=dp_sigma, aggregator=aggregator,
                                    loss_fn=loss_fn)
        hist["loss"].append(float(loss))
        if eval_fn is not None and ((t + 1) % eval_every == 0
                                    or t + 1 == rounds):
            hist["eval"].append(eval_fn(params))
    return params, hist


# ---------------------------------------------------------------------------
# Non-federated baselines (client-local / centralized ERM)
# ---------------------------------------------------------------------------


def sgd_train(gen, data_i, rcfg: RouterConfig, fcfg: FedConfig, *,
              steps: int, optimizer: str = "adamw", init=None, freeze=None,
              loss_fn=None):
    """Plain minibatch training on a single (flat) dataset
    {"x": (D,d), "m", "acc", "cost", "w"} — the no-FL baseline, and §6.3
    onboarding's trainer with a ``freeze`` mask. ``loss_fn`` selects the
    family's loss (None: the MLP router's). Returns (params, per-step
    losses (steps,))."""
    opt = _make_opt(fcfg, optimizer)
    params = init if init is not None else R.init_mlp_router(gen, rcfg)
    stacked = tree_map(lambda t: t[None].clone(), params)
    data = {k: v[None] for k, v in data_i.items()}
    n_steps = torch.full((1,), steps, device=data["x"].device)
    stacked, losses = _local_steps(stacked, data, gen, rcfg, fcfg, opt, steps,
                                   n_steps, full_batch=False, loss_fn=loss_fn,
                                   freeze=freeze)
    return tree_map(lambda t: t[0], stacked), losses[:, 0]
