"""K-means nearest-centroid assignment and the Lloyd-step reduction: the
CUDA kernels ``csrc/kmeans_assign.cu`` and their plain PyTorch versions.

Replaces the TPU kernels ``repro/kernels/kmeans_assign.py ::
kmeans_assign_pallas`` and ``kmeans_assign_reduce_pallas``.

Both take a batch of problems: x (G, n, d), cents (G·R, K, d) and, for the
reduction, w (G, n); problem p reads the data slab p // R, so the R
restarts of one client's Lloyd run share one copy of its data. The 2-D
reference signature x (n, d), cents (K, d), w (n,) is the batch of one and
returns unbatched results. The reduction is deterministic on the card
(see the kernel's source): the same inputs give the same sums bit for bit.
``kmeans_reduce_segmented_emulation`` is its summation order in plain
PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: launches of the CUDA kernels since the last reset (``ops.reset_launch_counts``)
COUNTS = {"kmeans_assign": 0, "kmeans_assign_reduce": 0}

#: the reduction's rows per segment and partials per tree group, constants
#: of ``csrc/kmeans_assign.cu`` (checked against the library when bound)
REDUCE_SEG = 256
REDUCE_FAN_IN = 16


def _batched(x, cents, w=None):
    """(x (G, n, d), cents (G·R, K, d), w (G, n) or None, R, was 2-D)."""
    flat = x.ndim == 2
    if flat:
        x, cents = x[None], cents[None]
        w = None if w is None else w[None]
    if x.ndim != 3 or cents.ndim != 3:
        raise ValueError(f"x {tuple(x.shape)} and cents {tuple(cents.shape)}"
                         " must both be 2-D or both 3-D")
    G, n, d = x.shape
    P, K, dc = cents.shape
    if dc != d or K < 1 or d < 1:
        raise ValueError(f"cents {tuple(cents.shape)} do not fit x "
                         f"{tuple(x.shape)} (need K >= 1, matching d >= 1)")
    if P % G:
        raise ValueError(f"{P} centroid sets do not divide among {G} data "
                         "slabs")
    if w is not None and tuple(w.shape) != (G, n):
        raise ValueError(f"w {tuple(w.shape)} must be {(G, n)}")
    return x, cents, w, P // G, flat


def _distances(x, cents, R):
    """(G, R, n, K) f32 ‖μ‖² − 2·x·μ, in one batched product."""
    G, n, d = x.shape
    c = cents.float().reshape(G, R, -1, d)
    c2 = (c * c).sum(-1)                                     # (G, R, K)
    xc = torch.matmul(x.float()[:, None], c.transpose(-1, -2))
    return c2[..., None, :] - 2.0 * xc


def kmeans_assign_plain(x, cents):
    """The kernel's function in plain PyTorch: (…, n) int32 argmin over the
    centroids of ‖μ‖² − 2·x·μ, f32, first index on ties."""
    x3, c3, _, R, flat = _batched(x, cents)
    a = torch.argmin(_distances(x3, c3, R), dim=-1).to(torch.int32)
    a = a.reshape(-1, x3.shape[1])
    return a[0] if flat else a


def kmeans_assign_reduce_plain(x, cents, w):
    """The assignment plus sums[k] = Σ_{a_i=k} w_i·x_i and counts[k] = Σ w_i
    by a one-hot product, all f32."""
    x3, c3, w2, R, flat = _batched(x, cents, w)
    G, n, d = x3.shape
    K = c3.shape[1]
    a = torch.argmin(_distances(x3, c3, R), dim=-1)          # (G, R, n)
    wv = F.one_hot(a, K).float() * w2.float()[:, None, :, None]
    sums = torch.matmul(wv.transpose(-1, -2), x3.float()[:, None])
    a, sums, cnts = (a.to(torch.int32).reshape(-1, n),
                     sums.reshape(-1, K, d), wv.sum(-2).reshape(-1, K))
    return (a[0], sums[0], cnts[0]) if flat else (a, sums, cnts)


def _fma(a, b, c):
    """f32 a·b + c with one rounding, as ``fmaf``: the f32 product is exact
    in f64 (and so, but for rare double roundings, is the result)."""
    return (a.double() * b.double() + c.double()).float()


def kmeans_reduce_segmented_emulation(x, cents, w, *, seg: int = REDUCE_SEG,
                                      fan_in: int = REDUCE_FAN_IN,
                                      assign=None):
    """The reduction kernel's summation order in plain PyTorch (for tests):
    each problem's rows in segments of ``seg``; in each segment, each
    cluster's w·x summed from 0 with fmaf over its rows in row order (rows
    with w = 0 dropped; an absent cluster sums to 0) and its weights added
    in the same order; then the segments' partials added in order from 0
    in groups of ``fan_in`` consecutive ones, level after level, until one
    is left. ``assign`` (the kernel's own assignment, (…, n) int32)
    replaces the plain argmin when given. Same arguments and result as
    ``kmeans_assign_reduce_plain``."""
    x3, c3, w2, R, flat = _batched(x, cents, w)
    G, n, d = x3.shape
    P, K, _ = c3.shape
    a = (kmeans_assign_plain(x3, c3) if assign is None
         else assign.reshape(P, n).to(torch.int32))
    nseg = max(1, -(-n // seg))
    pad = nseg * seg - n
    xs = F.pad(x3.float(), (0, 0, 0, pad)).repeat_interleave(R, 0)
    xs = xs.reshape(P, nseg, seg, d)
    ws = F.pad(w2.float(), (0, pad)).repeat_interleave(R, 0)
    ws = ws.reshape(P, nseg, seg)
    ks = F.pad(a.long(), (0, pad)).reshape(P, nseg, seg)
    sums = x3.new_zeros((P, nseg, K, d), dtype=torch.float32)
    cnts = x3.new_zeros((P, nseg, K), dtype=torch.float32)
    for j in range(seg):                  # position j of every segment
        k, wj = ks[:, :, j:j + 1], ws[:, :, j:j + 1]
        keep = wj != 0
        idx = k[..., None].expand(P, nseg, 1, d)
        cur = sums.gather(2, idx)
        new = _fma(wj[..., None], xs[:, :, j:j + 1], cur)
        sums.scatter_(2, idx, torch.where(keep[..., None], new, cur))
        cur = cnts.gather(2, k)
        cnts.scatter_(2, k, torch.where(keep, cur + wj, cur))
    while sums.shape[1] > 1:              # the tree, one level a pass
        m = sums.shape[1]
        g = -(-m // fan_in)
        sums = F.pad(sums, (0, 0, 0, 0, 0, g * fan_in - m)).reshape(
            P, g, fan_in, K, d)
        cnts = F.pad(cnts, (0, 0, 0, g * fan_in - m)).reshape(P, g, fan_in, K)
        s_acc = torch.zeros_like(sums[:, :, 0])
        c_acc = torch.zeros_like(cnts[:, :, 0])
        for i in range(fan_in):
            s_acc = s_acc + sums[:, :, i]
            c_acc = c_acc + cnts[:, :, i]
        sums, cnts = s_acc, c_acc
    sums, cnts = sums[:, 0], cnts[:, 0]
    return (a[0], sums[0], cnts[0]) if flat else (a, sums, cnts)


def _args(x, cents, w=None):
    x3, c3, w2, R, flat = _batched(x, cents, w)
    if not x.is_cuda:
        raise ValueError("the kmeans CUDA kernels need CUDA tensors")
    if x3.dtype != c3.dtype or x3.dtype not in (torch.float32,
                                                torch.bfloat16):
        x3, c3 = x3.float(), c3.float()
    x3, c3 = x3.contiguous(), c3.contiguous()
    w2 = None if w2 is None else w2.float().contiguous()
    if any(t is not None and t.device != x.device for t in (c3, w2)):
        raise ValueError("kmeans inputs must share one device")
    dtype = 1 if x3.dtype == torch.bfloat16 else 0
    return x3, c3, w2, R, flat, dtype


_ARGTYPES = {
    "kmeans_assign": [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2,
    "kmeans_assign_reduce": [ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6,
    "kmeans_reduce_plan": [ctypes.c_int] * 4
    + [ctypes.POINTER(ctypes.c_longlong)],
}
_FNS = {}   # name: (library, bound function) once loaded


def _fn(name):
    if name not in _FNS:
        lib = _build.load("kmeans_assign")
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = (lib, fn)
    return _FNS[name]


def _plan(P: int, n: int, K: int, d: int):
    """(workspace words, counters) of one reduction; the library's segment
    and fan-in must be this module's (the emulation's) constants."""
    out = (ctypes.c_longlong * 4)()
    _fn("kmeans_reduce_plan")[1](P, n, K, d, out)
    if (out[2], out[3]) != (REDUCE_SEG, REDUCE_FAN_IN):
        raise RuntimeError(f"csrc/kmeans_assign.cu reduces in segments of "
                           f"{out[2]}, groups of {out[3]}; this module says "
                           f"{REDUCE_SEG}, {REDUCE_FAN_IN}")
    return out[0], out[1]


#: the reduction's group counters on each device: zeroed once when
#: allocated, left zero by every launch (see the kernel's source); one
#: stream at a time uses them
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(n: int, device: torch.device) -> torch.Tensor:
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        size = max(n, 1024, 0 if c is None else 2 * c.numel())
        c = _COUNTERS[device] = torch.zeros(size, dtype=torch.int32,
                                            device=device)
    return c


def kmeans_assign_cuda(x, cents):
    """Launch the assignment kernel; (n,) or (P, n) int32."""
    x3, c3, _, R, flat, dtype = _args(x, cents)
    G, n, d = x3.shape
    P, K, _ = c3.shape
    dev = x3.device
    assign = torch.empty((P, n), dtype=torch.int32, device=dev)
    lib, fn = _fn("kmeans_assign")
    err = fn(dtype, x3.data_ptr(), c3.data_ptr(), P, R, n, K, d,
             assign.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "kmeans_assign")
    COUNTS["kmeans_assign"] += 1
    return assign[0] if flat else assign


def kmeans_assign_reduce_cuda(x, cents, w):
    """Launch the assignment and the deterministic reduction; returns
    (assign int32, sums f32, counts f32), unbatched for 2-D inputs."""
    x3, c3, w2, R, flat, dtype = _args(x, cents, w)
    G, n, d = x3.shape
    P, K, _ = c3.shape
    dev = x3.device
    words, n_ctr = _plan(P, n, K, d)
    assign = torch.empty((P, n), dtype=torch.int32, device=dev)
    sums = torch.empty((P, K, d), dtype=torch.float32, device=dev)
    cnts = torch.empty((P, K), dtype=torch.float32, device=dev)
    ws = torch.empty((words,), dtype=torch.float32, device=dev)
    ctr = _counters(n_ctr, dev)
    lib, fn = _fn("kmeans_assign_reduce")
    err = fn(dtype, x3.data_ptr(), c3.data_ptr(), w2.data_ptr(), P, R, n, K,
             d, assign.data_ptr(), sums.data_ptr(), cnts.data_ptr(),
             ws.data_ptr(), ctr.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "kmeans_assign_reduce")
    COUNTS["kmeans_assign_reduce"] += 1
    return (assign[0], sums[0], cnts[0]) if flat else (assign, sums, cnts)
