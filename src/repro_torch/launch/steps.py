"""Step builders of the drivers (PyTorch counterpart of
``repro/launch/steps.py``): one training step, a serving prefill and a
one-token decode, with the reference's signatures.

Parameters are trees of plain tensors, updated functionally: the train
step takes the gradients with ``torch.autograd.grad`` over the leaves and
returns a new tree from ``AdamW.update``.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import model as mdl
from repro_torch.train.optim import AdamW, tree_leaves, tree_map


def make_train_step(cfg: ModelConfig, *, moe_mode: str = "dense",
                    q_chunk: int = 512, lr=3e-4,
                    attn_layout: str = "grouped"):
    """(params, opt_state, batch) → (params, opt_state, loss): the loss,
    its gradients and an AdamW update (weight decay 0.1, global-norm clip
    1.0). ``lr`` is a float or a schedule of the step. Returns
    (train_step, opt)."""
    opt = AdamW(lr=lr, weight_decay=0.1, clip_norm=1.0)

    def train_step(params, opt_state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = mdl.loss_fn(params, cfg, batch, moe_mode=moe_mode,
                           q_chunk=q_chunk, attn_layout=attn_layout)
        leaves = tree_leaves(params)
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(grads), params)
        with torch.no_grad():
            params, opt_state = opt.update(
                grads, opt_state, tree_map(torch.Tensor.detach, params))
        return params, opt_state, loss.detach()

    return train_step, opt


def make_prefill_step(cfg: ModelConfig, *, moe_mode: str = "dense",
                      q_chunk: int = 512, attn_layout: str = "grouped"):
    """(params, batch) → (last-token logits[, decode cache]): serving
    prefill. Encoder-only archs score the batch (no cache)."""
    want_cache = cfg.supports_decode

    @torch.no_grad()
    def prefill_step(params, batch):
        out = mdl.forward(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), moe_mode=moe_mode,
                          q_chunk=q_chunk, logits_last_only=True,
                          return_cache=want_cache, attn_layout=attn_layout)
        if want_cache:
            logits, _, cache = out
            return logits, cache
        logits, _ = out
        return logits

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, rolling: bool = False,
                     moe_mode: str = "dense"):
    """(params, cache, tokens, pos) → (logits, cache): one token, the
    cache written in place (on CUDA through the ``decode_attention``
    kernel)."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return mdl.decode_step(params, cache, cfg, tokens=tokens, pos=pos,
                               rolling=rolling, moe_mode=moe_mode)

    return serve_step
