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
from repro_torch.models.model import block_pattern


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


#: leaves the reference keeps in f32 whatever the model dtype
_F32_LEAVES = ("router", "A_log", "D", "dt_bias")


def _layer_shapes(cfg: ModelConfig, mixer: str, ffn) -> dict:
    """(sub-tree, leaf) → per-unit shape of the leaves that fix a layer's
    kind and width: the mixer's input projection, the FFN's first weight
    and, for MoE, the expert-leading weights and the router."""
    d = cfg.d_model
    if mixer == "attn":
        want = {("mixer", "wq"): (d, cfg.n_heads * cfg.head_dim)}
    else:
        s = cfg.ssm
        d_inner = s.expand * d
        want = {("mixer", "in_proj"):
                (d, 2 * d_inner + 2 * s.d_state + d_inner // s.head_dim)}
    if ffn == "moe":
        E, f = cfg.moe.num_experts, cfg.moe.d_expert
        want.update({("ffn", "router"): (d, E), ("ffn", "wg"): (E, d, f),
                     ("ffn", "wu"): (E, d, f), ("ffn", "wd"): (E, f, d)})
    elif ffn == "mlp":
        want[("ffn", "wi" if cfg.encoder_only else "wg")] = (d, cfg.d_ff)
    return want


def _named_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, path + (k,))
    else:
        yield path, tree


def model_params_from_numpy(tree: dict, cfg: ModelConfig,
                            device: DeviceLike = None) -> dict:
    """The port's parameter dict for a reference model tree (any arch),
    checked against ``cfg``: the embedding tables, the block layout
    (``l0 … l{P−1}`` stacked ``n_units`` deep), each layer's kind and
    widths, the experts' leading dims, and the dtypes (the model dtype,
    f32 for the router and the SSM's ``A_log``, ``D`` and ``dt_bias``)."""
    dev = resolve_device(device)
    out = _tree(tree, dev)
    emb = out["embed"]
    want = {"unembed": (cfg.d_model, cfg.vocab)}
    if cfg.frontend is None or cfg.supports_decode:
        want["tok"] = (cfg.vocab, cfg.d_model)
    if sorted(emb) != sorted(want):
        raise ValueError(f"embed holds {sorted(emb)}, {cfg.name} needs "
                         f"{sorted(want)}")
    for k, shape in want.items():
        if tuple(emb[k].shape) != shape:
            raise ValueError(f"embed/{k} is {tuple(emb[k].shape)}, "
                             f"{cfg.name} needs {shape}")
    n_units, pat = block_pattern(cfg)
    blocks = out["blocks"]
    names = [f"l{i}" for i in range(len(pat))]
    if sorted(blocks) != sorted(names):
        raise ValueError(f"blocks hold {sorted(blocks)}, {cfg.name}'s unit "
                         f"has {names}")
    for name, (mixer, ffn) in zip(names, pat):
        for (sub, leaf), shape in _layer_shapes(cfg, mixer, ffn).items():
            got = blocks[name].get(sub, {}).get(leaf)
            if got is None:
                raise ValueError(f"blocks/{name}/{sub}/{leaf} is missing: "
                                 f"{cfg.name}'s layer {name} is "
                                 f"({mixer}, {ffn})")
            if got.shape[0] != n_units:
                raise ValueError(f"blocks are stacked {got.shape[0]} deep, "
                                 f"{cfg.name} has {n_units} units of "
                                 f"{len(pat)} layers")
            if tuple(got.shape[1:]) != shape:
                raise ValueError(f"blocks/{name}/{sub}/{leaf} is "
                                 f"{tuple(got.shape[1:])} per unit, "
                                 f"{cfg.name} needs {shape}")
    model_dt = getattr(torch, cfg.dtype)
    for path, leaf in _named_leaves(out):
        want_dt = torch.float32 if path[-1] in _F32_LEAVES else model_dt
        if leaf.dtype != want_dt:
            raise ValueError(f"{'/'.join(path)} is {leaf.dtype}, {cfg.name} "
                             f"runs in {cfg.dtype}")
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
