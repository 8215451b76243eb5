"""Pytree checkpointing via msgpack (PyTorch counterpart of
``repro/train/checkpoint.py``), byte-compatible with the reference's files.

Arrays are serialized as {"__arr__": True, "dtype", "shape", "data": raw
bytes}; dicts stay msgpack maps in their own key order, lists and tuples
become {"__list__": [...], "__tuple__": bool}. bfloat16 goes through a
uint16 view. Writes are atomic (tmp + rename). msgpack is imported inside
``save`` / ``restore`` only, so the port imports without it.
"""
from __future__ import annotations

import os
import pathlib
from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_ARR = "__arr__"


def _pack(obj: Any):
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu().contiguous()
            a = (t.view(torch.int16).numpy().view(np.uint16)
                 if t.dtype == torch.bfloat16 else t.numpy())
            dt = "bfloat16" if t.dtype == torch.bfloat16 else str(a.dtype)
        else:
            a, dt = obj, str(obj.dtype)
            if dt == "bfloat16":
                a = a.view(np.uint16)
        return {_ARR: True, "dtype": dt, "shape": list(a.shape),
                "data": np.ascontiguousarray(a).tobytes()}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return {"__list__": [_pack(v) for v in obj],
                "__tuple__": isinstance(obj, tuple)}
    return obj


def _unpack(obj: Any, device: torch.device):
    if isinstance(obj, dict):
        if obj.get(_ARR):
            dt, shape = obj["dtype"], obj["shape"]
            if dt == "bfloat16":
                a = np.frombuffer(obj["data"], np.int16).reshape(shape)
                return torch.from_numpy(a.copy()).view(torch.bfloat16).to(
                    device)
            a = np.frombuffer(obj["data"], np.dtype(dt)).reshape(shape)
            return torch.from_numpy(a.copy()).to(device)
        if "__list__" in obj:
            vals = [_unpack(v, device) for v in obj["__list__"]]
            return tuple(vals) if obj.get("__tuple__") else vals
        return {k: _unpack(v, device) for k, v in obj.items()}
    return obj


def save(path: str | pathlib.Path, tree: Any) -> None:
    import msgpack
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(_pack(tree), use_bin_type=True))
    os.replace(tmp, path)


def restore(path: str | pathlib.Path, device: DeviceLike = None) -> Any:
    """The tree saved at ``path``, its arrays as tensors on ``device`` (the
    CUDA device unless it names another)."""
    import msgpack
    dev = resolve_device(device)
    with open(path, "rb") as f:
        return _unpack(msgpack.unpackb(f.read(), raw=False,
                                       strict_map_key=False), dev)
