"""Optimizers (PyTorch counterpart of ``repro/train/optim.py``).

The reference's own AdamW and SGD, not ``torch.optim``: the order of
operations is the reference's — global-norm clip first, f32 first and
second moments, bias correction, eps added after the square root, weight
decay added to the update before the ×lr. Params, grads and moments are
pytrees (nested dicts and lists) of tensors, updated functionally.

Batched clients: when ``state.step`` has a leading axis (one step count
per client, params stacked along the same axis), the global norm of the
clip is taken per client over that client's slices, and the bias
correction uses each client's own step count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(N,) or () ``v`` broadcast against a leaf with the same leading axes."""
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


class AdamWState(NamedTuple):
    step: torch.Tensor      # () or (N,) int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None

    def init(self, params, *, batch: Optional[int] = None) -> AdamWState:
        """Zero moments; ``batch=N`` gives N clients their own step count
        (params then stacked along a leading axis of N)."""
        leaf = tree_leaves(params)[0]
        shape = () if batch is None else (batch,)
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(torch.zeros(shape, dtype=torch.int32,
                                      device=leaf.device),
                          tree_map(z, params), tree_map(z, params))

    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        lead = step.ndim
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm, lead=lead)
        b1, b2, lr = self.b1, self.b2, self.lr
        m = tree_map(lambda mu, g: b1 * mu + (1 - b1) * g.float(),
                     state.m, grads)
        v = tree_map(lambda nu, g: b2 * nu + (1 - b2) * torch.square(
            g.float()), state.v, grads)
        t = step.float()
        mhat_scale = 1.0 / (1 - torch.pow(b1, t))
        vhat_scale = 1.0 / (1 - torch.pow(b2, t))

        def upd(p, mu, nu):
            ms, vs = _bcast(mhat_scale, p), _bcast(vhat_scale, p)
            u = (mu * ms) / (torch.sqrt(nu * vs) + self.eps)
            u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        return tree_map(upd, params, m, v), AdamWState(step, m, v)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 1e-2
    clip_norm: Optional[float] = None

    def init(self, params, *, batch: Optional[int] = None) -> torch.Tensor:
        leaf = tree_leaves(params)[0]
        shape = () if batch is None else (batch,)
        return torch.zeros(shape, dtype=torch.int32, device=leaf.device)

    def update(self, grads, state: torch.Tensor, params):
        step = state + 1
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm, lead=step.ndim)
        new = tree_map(lambda p, g: (p.float() - self.lr * g.float()).to(
            p.dtype), params, grads)
        return new, step


def global_norm(tree, *, lead: int = 0) -> torch.Tensor:
    """√(Σ g²) over every leaf; with ``lead=1`` one norm per client (the
    leading axis is kept, every other axis is summed)."""
    tot = sum(torch.square(g.float()).reshape(
        g.shape[:lead] + (-1,)).sum(-1) for g in tree_leaves(tree))
    return torch.sqrt(tot)


def clip_by_global_norm(grads, max_norm: float, *, lead: int = 0):
    gn = global_norm(grads, lead=lead)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: g * _bcast(scale, g).to(g.dtype), grads)
