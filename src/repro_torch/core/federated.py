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
onboarding) apply as in the reference, and so do per-round cohort
sampling (``cohort=``) and the staleness vector of buffered-async
strategies (``staleness=``).

``fedavg(mesh=)`` runs every round through ``fedavg_round_sharded``:
each process of a ``sharding.client_mesh`` trains the round's clients
that it holds and the server aggregation runs replicated, equal to the
in-process fit (see that function).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch import sharding as shd
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.core import mlp_router as R
from repro_torch.fed.aggregators import (FedAvgAggregator,
                                         GaussianDPAggregator, select_clients)
from repro_torch.train.optim import (SGD, AdamW, AdamWState, masked_update,
                                     tree_leaves, tree_map)


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
            u = shd.rand((N, fcfg.batch_size), gen, device=dev,
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


def _strategy(aggregator, dp_sigma: float):
    """The round's strategy: FedAvg by default, DP noise over any."""
    if aggregator is None:
        return _default_aggregator(dp_sigma)
    if dp_sigma > 0.0:
        return GaussianDPAggregator(sigma=dp_sigma, inner=aggregator)
    return aggregator


def _draw_cohort(gen, n: int, cohort: int) -> torch.Tensor:
    """The round's cohort: ``cohort`` of the ``n`` stacked clients, in the
    order of a permutation drawn from ``gen``."""
    return torch.randperm(n, generator=gen, device=gen.device)[:cohort]


def _draw_active(gen, N: int, fcfg: FedConfig, dev, client_mask=None):
    """The round's participants among N stacked clients: (0/1 mask (N,),
    their stack positions in order)."""
    n_active = max(1, int(round(fcfg.participation * N)))
    drawn = torch.randperm(N, generator=gen, device=dev)[:n_active]
    active = torch.zeros(N, device=dev)
    active[drawn] = 1.0
    if client_mask is not None:
        mask = torch.as_tensor(client_mask, dtype=torch.float32, device=dev)
        active = active * mask
        if float(active.sum()) <= 0:
            active = mask
    return active, torch.nonzero(active).reshape(-1)


def _aggregate(agg, params, client_params, client_loss, wts, idx, N, gen,
               staleness):
    """The server side of a round on the stack of its trained clients:
    the strategy (restricted to their stack positions ``idx`` of N) and
    the weighted mean loss."""
    agg = select_clients(agg, idx, N)
    extras = {}
    if getattr(agg, "needs_prev", False):
        extras["prev"] = params
    if getattr(agg, "needs_staleness", False):
        extras["staleness"] = (torch.zeros_like(wts) if staleness is None
                               else staleness[idx].float())
    new_params = agg(client_params, wts, gen, **extras)
    wn = wts / torch.clamp(wts.sum(), min=1e-12)
    return new_params, (client_loss * wn).sum()


def fedavg_round(params, data, gen, rcfg: RouterConfig, fcfg: FedConfig,
                 opt, max_steps: int, *, full_batch: bool = False,
                 freeze=None, distill=None, client_mask=None,
                 dp_sigma: float = 0.0, aggregator=None, loss_fn=None,
                 cohort: Optional[int] = None, staleness=None):
    """One communication round: local updates on the active clients and
    the server aggregation (Alg. 1 lines 3–11). round(participation·N)
    clients are drawn by a permutation; ``client_mask`` (N,) restricts
    them to the eligible pool, and when none of the drawn ones is eligible
    the whole pool trains (App. D.3). The aggregation weights are the
    active clients' dataset sizes. dp_sigma > 0 adds server-side Gaussian
    noise over whichever strategy runs.

    ``cohort=C`` first gathers C of the N stacked clients (``_draw_cohort``)
    and the round runs on that (C, ...) slab; ``participation`` applies
    within it. ``staleness`` (N,) is gathered with the cohort and handed to
    strategies that declare ``needs_staleness``; strategies that declare
    ``needs_prev`` get the round's input params. Only the active clients
    train, so the strategy sees the compacted stack and everything indexed
    by stack position (staleness, ``select_clients``) is gathered with the
    same indices."""
    N = data["x"].shape[0]
    dev = data["x"].device
    if cohort is not None:
        pick = _draw_cohort(gen, N, cohort)
        data = {k: v[pick] for k, v in data.items()}
        if staleness is not None:
            staleness = staleness[pick]
        N = cohort
    active, idx = _draw_active(gen, N, fcfg, dev, client_mask)
    sub = {k: v[idx] for k, v in data.items()}
    client_params, client_loss = client_update(
        params, sub, gen, rcfg, fcfg, opt, max_steps, full_batch=full_batch,
        freeze=freeze, distill=distill, loss_fn=loss_fn)
    wts = dataset_sizes(sub) * active[idx]
    return _aggregate(_strategy(aggregator, dp_sigma), params, client_params,
                      client_loss, wts, idx, N, gen, staleness)


def pad_client_axis(data, multiple: int, staleness=None):
    """Pad the stacked client axis up to a multiple of ``multiple`` with
    empty clients (all-zero rows, ``w = 0`` — zero aggregation weight, so
    they never move the params). Returns ``(data, staleness)`` — the
    staleness vector, when given, pads with zeros. Used by mesh callers
    whose organic client count doesn't divide the device axis."""
    N = next(iter(data.values())).shape[0]
    pad = (-N) % int(multiple)
    if pad == 0:
        return data, staleness
    def grow(v):
        v = torch.as_tensor(v)
        return torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
    data = {k: grow(v) for k, v in data.items()}
    if staleness is not None:
        st = torch.as_tensor(staleness, dtype=torch.float32)
        staleness = torch.cat([st, torch.zeros((pad,), device=st.device)])
    return data, staleness


def _pack(tree_stack, *cols) -> tuple:
    """A (L, ...) stack of trees and (L,) columns as one (L, k) matrix,
    and the function that unpacks a (n, k) matrix of the same layout."""
    leaves = tree_leaves(tree_stack)
    L = leaves[0].shape[0]
    dt = leaves[0].dtype
    if any(t.dtype != dt for t in leaves + list(cols)):
        raise TypeError("the gathered client stack must have one dtype")
    flat = torch.cat([t.reshape(L, -1) for t in leaves]
                     + [c.reshape(L, 1) for c in cols], dim=1)
    sizes = [t[0].numel() for t in leaves]
    shapes = [tuple(t.shape[1:]) for t in leaves]

    def unpack(m: torch.Tensor):
        n = m.shape[0]
        parts = list(torch.split(m, sizes + [1] * len(cols), dim=1))
        # contiguous, as the in-process stacks are (the same reduction
        # orders in the aggregation)
        it = iter(p.reshape((n,) + sh).contiguous()
                  for p, sh in zip(parts, shapes))
        return (tree_map(lambda _: next(it), tree_stack),
                *(p.reshape(n).contiguous() for p in parts[len(sizes):]))
    return flat, unpack


def _pad_rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """t (n, ...) with empty clients (zeros) appended up to ``width``."""
    extra = width - t.shape[0]
    if extra == 0:
        return t
    return torch.cat([t, torch.zeros((extra,) + tuple(t.shape[1:]),
                                     dtype=t.dtype, device=t.device)])


def fedavg_round_sharded(params, data, gen, rcfg: RouterConfig,
                         fcfg: FedConfig, opt, max_steps: int, *, mesh,
                         full_batch: bool = False, dp_sigma: float = 0.0,
                         aggregator=None, loss_fn=None,
                         cohort: Optional[int] = None, staleness=None):
    """``fedavg_round`` over a ``"clients"`` mesh: each process trains the
    round's clients that it holds and the server aggregation runs
    replicated in every process. No client's data leaves its process.

    Process q holds the clients of block q of the N stacked ones (its
    ``Shard(0)`` block, or the same block of a stack every process
    holds). Equal to the in-process round: every random draw (cohort,
    active set, minibatch rows, dropout masks) is made replicated from the
    same generator stream, over the whole stack of the round's active
    clients that the in-process round draws for, and each process keeps
    the rows of its own clients (``sharding.ClientRows``). The round
    trains exactly the in-process set: process q trains its A_q active
    clients, padded to L = max A_q with empty clients that draw nothing,
    take no step and are dropped. The client updates, losses and dataset
    sizes return to the server through one all-gather (data movement
    only) and are put back in the in-process stack order, so every
    ``Aggregator`` — robust, DP and staleness-aware ones included — sees
    the in-process stack. The all-gather moves n · L rows of (the
    router's parameters, the loss, the dataset size) a round."""
    r, n = shd.clients_rank(mesh)
    local, N, lo_own, whole = shd.local_block(data, mesh)
    dev = local["x"].device
    ids = torch.arange(N, device=dev)
    if cohort is not None:
        ids = _draw_cohort(gen, N, cohort)
        if staleness is not None:
            staleness = staleness[ids]
    active, idx = _draw_active(gen, ids.shape[0], fcfg, dev)
    A = idx.shape[0]
    owner = ids[idx] // (N // n)                 # the process holding each
    counts = torch.bincount(owner, minlength=n)
    L = int(counts.max())
    mine = torch.nonzero(owner == r).reshape(-1)   # stack positions, in order
    held = ids[idx][mine] - (0 if whole else lo_own)
    sub = {k: _pad_rows(v[held], L) for k, v in local.items()}
    rows = gen if n == 1 else shd.ClientRows(gen, mine, A, L)
    cp_loc, closs_loc = client_update(params, sub, rows, rcfg, fcfg, opt,
                                      max_steps, full_batch=full_batch,
                                      loss_fn=loss_fn)
    flat, unpack = _pack(cp_loc, closs_loc, dataset_sizes(sub))
    gathered = shd.all_gather_rows(flat, mesh)           # (n·L, k)
    # row j of the round: its process's block, at its rank there
    first = torch.cumsum(counts, 0) - counts
    order = torch.argsort(owner, stable=True)
    slot = torch.empty_like(order)
    slot[order] = (owner[order] * L + torch.arange(A, device=dev)
                   - first[owner[order]])
    client_params, client_loss, sizes = unpack(gathered[slot])
    wts = sizes * active[idx]
    return _aggregate(_strategy(aggregator, dp_sigma), params, client_params,
                      client_loss, wts, idx, ids.shape[0], gen, staleness)


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
    ``fedavg_round``). ``cohort=C`` trains C sampled clients per round
    (C >= N is full participation); ``staleness`` (N,) feeds a strategy
    that declares ``needs_staleness`` and is refused by any other. Returns
    (params, {"loss": per-round loss, "eval": ``eval_fn(params)`` after
    every ``eval_every`` rounds and after the last}).

    ``mesh=`` (a ``sharding.client_mesh``) runs every round through
    ``fedavg_round_sharded``: equal to the in-process fit on the same
    generator seed in every process. It takes every knob but the ones
    that carry trees or per-client masks (freeze, distill, client_mask),
    and N (and a cohort) must divide the mesh."""
    rounds = rounds if rounds is not None else fcfg.rounds
    N = data["x"].shape[0]
    if mesh is not None:
        pytree_kw = [n for n, v in (("freeze", freeze), ("distill", distill),
                                    ("client_mask", client_mask))
                     if v is not None]
        if pytree_kw:
            raise ValueError(
                f"the mesh path supports only hashable knobs — "
                f"{', '.join(pytree_kw)} carry pytrees that would pin the "
                "sharded round to one fit; drop mesh= to use the "
                "in-process simulation with those")
        _, n_dev = shd.clients_rank(mesh)
        if N % n_dev != 0:
            raise ValueError(
                f"N={N} stacked clients do not divide the {n_dev}-device "
                "clients mesh — pad the stack (pad_client_axis) or resize "
                "the mesh")
        if cohort is not None and cohort < N and cohort % n_dev != 0:
            raise ValueError(
                f"cohort={cohort} does not divide the {n_dev}-device "
                "clients mesh — each device trains cohort/n_dev clients "
                "per round, so pick a multiple")
    if cohort is not None:
        if client_mask is not None:
            raise ValueError(
                "cohort sampling and client_mask are mutually exclusive: "
                "the mask is indexed by the full client axis, the cohort "
                "gather re-indexes it per round")
        cohort = int(cohort)
        if cohort < 1:
            raise ValueError(f"cohort must be >= 1, got {cohort}")
        if cohort >= N:
            cohort = None  # full participation
    if staleness is not None:
        # GaussianDP forwards needs_staleness from its inner strategy, so
        # checking the caller's aggregator covers the dp_sigma > 0 wrap too
        if not getattr(aggregator, "needs_staleness", False):
            name = type(aggregator).__name__ if aggregator is not None \
                else "default FedAvg"
            raise ValueError(
                f"staleness= was provided but the aggregator ({name}) does "
                "not consume it — use a buffered-async strategy (e.g. "
                "BufferedAsyncAggregator) or drop the argument")
        staleness = torch.as_tensor(staleness, dtype=torch.float32,
                                    device=data["x"].device)
        if tuple(staleness.shape) != (N,):
            raise ValueError(
                f"staleness must have shape ({N},) — one entry per stacked "
                f"client — got {tuple(staleness.shape)}")
    D_max = data["x"].shape[1]
    max_steps = 1 if full_batch else max(
        1, math.ceil(D_max / fcfg.batch_size)) * fcfg.local_epochs
    params = init if init is not None else R.init_mlp_router(gen, rcfg)
    opt = _make_opt(fcfg, optimizer)
    hist = {"loss": [], "eval": []}
    for t in range(rounds):
        if mesh is not None:
            params, loss = fedavg_round_sharded(
                params, data, gen, rcfg, fcfg, opt, max_steps, mesh=mesh,
                full_batch=full_batch, dp_sigma=dp_sigma,
                aggregator=aggregator, loss_fn=loss_fn, cohort=cohort,
                staleness=staleness)
        else:
            params, loss = fedavg_round(
                params, data, gen, rcfg, fcfg, opt, max_steps,
                full_batch=full_batch, freeze=freeze, distill=distill,
                client_mask=client_mask, dp_sigma=dp_sigma,
                aggregator=aggregator, loss_fn=loss_fn, cohort=cohort,
                staleness=staleness)
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
