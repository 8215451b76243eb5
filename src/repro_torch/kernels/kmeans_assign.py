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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: launches of the CUDA kernels since the last reset (``ops.reset_launch_counts``)
COUNTS = {"kmeans_assign": 0, "kmeans_assign_reduce": 0}


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


def _args(x, cents, w=None):
    if not x.is_cuda:
        raise ValueError("the kmeans CUDA kernels need CUDA tensors")
    x3, c3, w2, R, flat = _batched(x, cents, w)
    if x3.dtype != c3.dtype or x3.dtype not in (torch.float32,
                                                torch.bfloat16):
        x3, c3 = x3.float(), c3.float()
    x3, c3 = x3.contiguous(), c3.contiguous()
    w2 = None if w2 is None else w2.float().contiguous()
    if any(t is not None and t.device != x.device for t in (c3, w2)):
        raise ValueError("kmeans inputs must share one device")
    dtype = 1 if x3.dtype == torch.bfloat16 else 0
    return x3, c3, w2, R, flat, dtype


def _assign_fn(lib):
    fn = lib.kmeans_assign
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _reduce_fn(lib):
    fn = lib.kmeans_assign_reduce
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def kmeans_assign_cuda(x, cents):
    """Launch the assignment kernel; (n,) or (P, n) int32."""
    x3, c3, _, R, flat, dtype = _args(x, cents)
    G, n, d = x3.shape
    P, K, _ = c3.shape
    dev = x3.device
    assign = torch.empty((P, n), dtype=torch.int32, device=dev)
    c2 = torch.empty((P, K), dtype=torch.float32, device=dev)
    lib = _build.load("kmeans_assign")
    err = _assign_fn(lib)(dtype, x3.data_ptr(), c3.data_ptr(), c2.data_ptr(),
                          P, R, n, K, d, assign.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
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
    assign = torch.empty((P, n), dtype=torch.int32, device=dev)
    sums = torch.empty((P, K, d), dtype=torch.float32, device=dev)
    cnts = torch.empty((P, K), dtype=torch.float32, device=dev)
    c2 = torch.empty((P, K), dtype=torch.float32, device=dev)
    lib = _build.load("kmeans_assign")
    err = _reduce_fn(lib)(dtype, x3.data_ptr(), c3.data_ptr(), w2.data_ptr(),
                          c2.data_ptr(), P, R, n, K, d, assign.data_ptr(),
                          sums.data_ptr(), cnts.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "kmeans_assign_reduce")
    COUNTS["kmeans_assign_reduce"] += 1
    return (assign[0], sums[0], cnts[0]) if flat else (assign, sums, cnts)
