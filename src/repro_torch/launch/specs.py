"""Layouts of the parameters, caches and inputs on a production mesh, as
data (PyTorch counterpart of ``repro/launch/specs.py``).

A mesh is a ``{axis: size}`` shape, e.g. ``{"data": 16, "model": 16}``
or ``{"pod": 2, "data": 16, "model": 16}``; no device mesh is needed to
compute a layout. A layout gives, for each dimension of a leaf, the mesh
axis it is split over: ``None`` (replicated), an axis name, or a tuple of
axis names (the batch over ``("pod", "data")``). The policy is the
reference's:

  * batch            → ("pod", "data")          (training, batched decode)
  * tensor-parallel  → "model" on head / ffn / expert / vocab dims
  * FSDP             → "data"  on the non-TP dim of large matrices
  * batch=1 decode   → KV-cache seq → "data"    (flash-decoding layout)

An axis that does not divide its dimension is dropped (``_fit``): the
dimension is replicated. ``per_device_bytes`` sums what one device holds
of a tree under its layouts. These are the layouts the serving mesh of a
later slice places its tensors by.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.config import InputShape, ModelConfig
from repro_torch.models import model as mdl

IN_NAMES = {"wq", "wk", "wv", "wg", "wu", "wi", "in_proj"}
OUT_NAMES = {"wo", "wd", "out_proj"}


def axis_size(mesh_shape: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh_shape[axis]
    return math.prod(mesh_shape[a] for a in axis)


def _fit(mesh_shape: dict, dims, shape) -> tuple:
    """Drop the axes that do not divide their dimension; a tuple of one
    axis is that axis (as a PartitionSpec holds it)."""
    def entry(ax):
        return ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
    return tuple(entry(ax) if ax is None
                 or d % axis_size(mesh_shape, ax) == 0 else None
                 for d, ax in zip(shape, dims))


def batch_axes(mesh_shape: dict) -> tuple:
    return ("pod", "data") if "pod" in mesh_shape else ("data",)


def _map(tree, fn, name=None):
    """fn(leaf name, leaf) over a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    return fn(name, tree)


def param_layouts(mesh_shape: dict, cfg: ModelConfig, params, *,
                  fsdp: bool = True) -> dict:
    """One layout per leaf of ``params`` (e.g. the meta-device tree of
    ``model.init_params(..., device="meta")``)."""
    fa = "data" if fsdp else None

    def leaf(name, x):
        nd = x.dim()
        dims = [None] * nd
        if nd == 4:                      # MoE experts (n_units, E, d_in, d_out)
            dims[1] = "model"
            if name in IN_NAMES:
                dims[2] = fa
            else:
                dims[3] = fa
        elif name in IN_NAMES and nd >= 2:
            dims[-2], dims[-1] = fa, "model"
        elif name in OUT_NAMES and nd >= 2:
            dims[-2], dims[-1] = "model", fa
        elif name == "tok":
            dims[0] = "model"            # vocab
        elif name == "unembed":
            dims[-2], dims[-1] = fa, "model"
        elif name == "conv_w":
            dims[-1] = "model"
        return _fit(mesh_shape, dims, x.shape)

    return _map(params, leaf)


def activation_rules(mesh_shape: dict, shape: InputShape,
                     kv_seq_axis: Optional[str] = None,
                     act_shard: bool = False) -> dict:
    """Logical axis → mesh axis. ``kv_seq_axis`` overrides where the
    decode cache's sequence is split; ``act_shard`` splits the residual
    stream's d_model over "model"."""
    ba = batch_axes(mesh_shape)
    b1 = shape.global_batch == 1
    return {
        "batch": None if b1 else ba,
        "tokens": None if b1 else ba,
        "seq": None,
        "heads": "model",
        "heads4d": "model",
        "embed": "model" if act_shard else None,
        "kv_heads": "model",
        "ffn": "model",
        "experts": "model",
        "vocab": "model",
        "kv_seq": kv_seq_axis if kv_seq_axis else ("data" if b1 else None),
    }


def cache_layouts(mesh_shape: dict, cfg: ModelConfig, cache, *,
                  global_batch: int,
                  kv_seq_axis: Optional[str] = None) -> dict:
    """Decode-cache layouts. Leaves: k/v (L, B, Hkv, S, hd), conv
    (L, B, K, C), state (L, B, H, hd, st)."""
    ba = batch_axes(mesh_shape)
    b1 = global_batch == 1
    seq_ax = kv_seq_axis if kv_seq_axis else ("data" if b1 else None)
    bax = None if b1 else ba

    def leaf(name, x):
        if name in ("k", "v"):
            dims = [None, bax, None, seq_ax, None]
        elif name == "conv":
            dims = [None, bax, None, "model"]
        elif name == "state":
            dims = [None, bax, "model", None, None]
        else:
            dims = [None] * x.dim()
        return _fit(mesh_shape, dims, x.shape)

    return _map(cache, leaf)


def input_shapes(cfg: ModelConfig, shape: InputShape, mesh_shape: dict,
                 kv_seq_axis: Optional[str] = None, *,
                 device="meta") -> tuple:
    """(inputs, layouts) of every model input of the step: tensors on
    ``device`` (the meta device: shapes and dtypes, nothing allocated).
    train / prefill: {"tokens" (or "embeds" for a modality frontend),
    "labels" (train only)}; decode: {"cache", "tokens" (B, 1), "pos"}."""
    B, S = shape.global_batch, shape.seq_len
    b_axis = _fit(mesh_shape, (batch_axes(mesh_shape),), (B,))[0]
    f = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    i32 = torch.int32

    if shape.kind in ("train", "prefill"):
        if cfg.frontend is not None:       # stubbed modality frontend
            batch = {"embeds": torch.empty((B, S, cfg.d_model), dtype=f,
                                           device=device),
                     "labels": torch.empty((B, S), dtype=i32, device=device)}
            lay = {"embeds": (b_axis, None, None), "labels": (b_axis, None)}
        else:
            batch = {"tokens": torch.empty((B, S), dtype=i32, device=device),
                     "labels": torch.empty((B, S), dtype=i32, device=device)}
            lay = {"tokens": (b_axis, None), "labels": (b_axis, None)}
        if shape.kind == "prefill":
            batch.pop("labels")
            lay.pop("labels")
        return batch, lay

    cache = mdl.init_decode_cache(cfg, B, S, device=device)
    return ({"cache": cache,
             "tokens": torch.empty((B, 1), dtype=i32, device=device),
             "pos": torch.empty((), dtype=i32, device=device)},
            {"cache": cache_layouts(mesh_shape, cfg, cache, global_batch=B,
                                    kv_seq_axis=kv_seq_axis),
             "tokens": (b_axis, None), "pos": ()})


def per_device_bytes(tree, layouts, mesh_shape: dict) -> int:
    """Bytes one device holds of ``tree`` (nested dicts of tensors) under
    ``layouts`` (the same nesting, one layout per leaf): each dimension
    split over its axes, the rest replicated."""
    if isinstance(tree, dict):
        return sum(per_device_bytes(tree[k], layouts[k], mesh_shape)
                   for k in tree)
    n = 1
    for d, ax in zip(tree.shape, layouts):
        n *= d // axis_size(mesh_shape, ax)
    return n * tree.element_size()
