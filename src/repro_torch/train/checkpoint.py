"""Pytree checkpointing in msgpack (PyTorch counterpart of
``repro/train/checkpoint.py``), byte-compatible with the reference's files.

Arrays are serialized as {"__arr__": True, "dtype", "shape", "data": raw
bytes}; dicts stay msgpack maps in their own key order, lists and tuples
become {"__list__": [...], "__tuple__": bool}. bfloat16 goes through a
uint16 view. Writes are atomic (tmp + rename).

The msgpack encoding is the port's own (``packb`` / ``unpackb``): the
subset these trees use — maps, arrays, str, bin, ints in their smallest
encoding, float64, nil and booleans — written byte for byte as
``msgpack.packb(obj, use_bin_type=True)`` writes it, and read as
``msgpack.unpackb(b, raw=False, strict_map_key=False)`` reads it (float32
included). The port needs no msgpack package.
"""
from __future__ import annotations

import os
import pathlib
import struct
from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_ARR = "__arr__"

# ---------------------------------------------------------------------------
# msgpack encoding
# ---------------------------------------------------------------------------


def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, hi in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                              (0xce, ">BI", 1 << 32), (0xcf, ">BQ", 1 << 64)):
            if v < hi:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    else:
        for code, fmt, lo in ((0xd0, ">Bb", -(1 << 7)),
                              (0xd1, ">Bh", -(1 << 15)),
                              (0xd2, ">Bi", -(1 << 31)),
                              (0xd3, ">Bq", -(1 << 63))):
            if v >= lo:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple,
              out: list) -> None:
    """A length header: the fix form below ``fix_max``, else the 8- (if
    any), 16- and 32-bit forms ``codes`` names."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, hi in zip(codes, (">BB", ">BH", ">BI")[-len(codes):],
                             (1 << 8, 1 << 16, 1 << 32)[-len(codes):]):
        if n < hi:
            out.append(struct.pack(fmt, code, n))
            return
    raise ValueError(f"msgpack length {n} exceeds 2**32 - 1")


def _encode(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), None, 0, (0xc4, 0xc5, 0xc6), out)
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (0xdc, 0xdd), out)
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (0xde, 0xdf), out)
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` in msgpack, as ``msgpack.packb(obj, use_bin_type=True)``."""
    out: list = []
    _encode(obj, out)
    return b"".join(out)


#: fixed-size codes → (struct format, byte size)
_FIXED = {0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
          0xca: (">f", 4), 0xcb: (">d", 8)}
#: length-prefixed codes → (kind, length format, length size)
_SIZED = {0xd9: ("str", ">B", 1), 0xda: ("str", ">H", 2),
          0xdb: ("str", ">I", 4), 0xc4: ("bin", ">B", 1),
          0xc5: ("bin", ">H", 2), 0xc6: ("bin", ">I", 4),
          0xdc: ("array", ">H", 2), 0xdd: ("array", ">I", 4),
          0xde: ("map", ">H", 2), 0xdf: ("map", ">I", 4)}


def _decode(buf: memoryview, i: int) -> tuple:
    """(value, next offset) of the object at ``buf[i]``."""
    c = buf[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xe0:
        return c - 0x100, i
    if 0x80 <= c < 0x90:
        kind, n = "map", c & 0x0f
    elif 0x90 <= c < 0xa0:
        kind, n = "array", c & 0x0f
    elif 0xa0 <= c < 0xc0:
        kind, n = "str", c & 0x1f
    elif c == 0xc0:
        return None, i
    elif c == 0xc2:
        return False, i
    elif c == 0xc3:
        return True, i
    elif c in _FIXED:
        fmt, size = _FIXED[c]
        return struct.unpack_from(fmt, buf, i)[0], i + size
    elif c in _SIZED:
        kind, fmt, size = _SIZED[c]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += size
    else:
        raise ValueError(f"msgpack type 0x{c:02x} at offset {i - 1} is not "
                         "one this checkpoint format writes")
    if kind == "str":
        return str(buf[i:i + n], "utf-8"), i + n
    if kind == "bin":
        return bytes(buf[i:i + n]), i + n
    if kind == "array":
        vals = []
        for _ in range(n):
            v, i = _decode(buf, i)
            vals.append(v)
        return vals, i
    out = {}
    for _ in range(n):
        k, i = _decode(buf, i)
        out[k], i = _decode(buf, i)
    return out, i


def unpackb(data: bytes) -> Any:
    """The object msgpack ``data`` holds, as ``msgpack.unpackb(data,
    raw=False, strict_map_key=False)`` reads it."""
    buf = memoryview(data)
    obj, end = _decode(buf, 0)
    if end != len(buf):
        raise ValueError(f"msgpack data has {len(buf) - end} extra bytes")
    return obj


# ---------------------------------------------------------------------------
# The checkpoint tree
# ---------------------------------------------------------------------------


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
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(packb(_pack(tree)))
    os.replace(tmp, path)


def restore(path: str | pathlib.Path, device: DeviceLike = None) -> Any:
    """The tree saved at ``path``, its arrays as tensors on ``device`` (the
    CUDA device unless it names another)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        return _unpack(unpackb(f.read()), dev)
