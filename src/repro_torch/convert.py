"""Carry weights and router state between the JAX reference and the port.

The input is the reference's parameter tree with every leaf turned into a
numpy array (``jax.tree.map(np.asarray, params)``): nested dicts, lists
kept as lists; ``state_to_numpy`` is the way back. The trees have the same
layout on both sides — ``params["blocks"]`` stays stacked along its leading
``n_units`` axis — so conversion is leaf by leaf. A bf16 leaf arrives as an ``ml_dtypes``
bfloat16 array, which torch cannot read directly; its bits are taken
through an int16 view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)          # a writable copy: the port owns its weights
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device) for v in tree]
    return _leaf(tree, device)


def model_params_from_numpy(tree: dict, cfg: ModelConfig,
                            device: DeviceLike = None) -> dict:
    """The port's parameter dict for a reference model tree (dense
    decoders), checked against ``cfg``'s shapes and dtype."""
    dev = resolve_device(device)
    out = _tree(tree, dev)
    emb = out["embed"]
    want = {"tok": (cfg.vocab, cfg.d_model), "unembed": (cfg.d_model, cfg.vocab)}
    for k, shape in want.items():
        if tuple(emb[k].shape) != shape:
            raise ValueError(f"embed/{k} is {tuple(emb[k].shape)}, "
                             f"{cfg.name} needs {shape}")
    wq = out["blocks"]["l0"]["mixer"]["wq"]
    if wq.shape[0] != cfg.n_layers:
        raise ValueError(f"blocks are stacked {wq.shape[0]} deep, "
                         f"{cfg.name} has {cfg.n_layers} layers")
    if wq.dtype != getattr(torch, cfg.dtype):
        raise ValueError(f"weights are {wq.dtype}, {cfg.name} runs in "
                         f"{cfg.dtype}")
    return out


def router_state_from_numpy(tree: dict, device: DeviceLike = None) -> dict:
    """The port's router state for a reference router state tree, leaf by
    leaf: MLP params ({"trunk": [...], "heads": {...}}), MF params
    ({"proj": {...}, "heads": {...}}), a K-means router ({"centroids", "A",
    "C", "n"}) or an Elo router ({"anchors", "rating", "C", "a", "c", "n",
    "tau"}, "tau" 0-d)."""
    return _tree(tree, resolve_device(device))


def state_to_numpy(tree):
    """The port's state or params as a tree of numpy arrays, the layout the
    reference takes (``jax.tree.map(jnp.asarray, ...)``). bf16 leaves come
    back as f32 (exact)."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [state_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
