"""Fused routing decision: the CUDA kernel ``csrc/router_utility.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/router_utility.py ::
router_utility_pallas``. Given trunk features h, compute each model's
accuracy and cost head projections, the utility U = σ(h·Wa+ba) − λ(h·Wc+bc)
and its argmax and max per row, without writing A, C or U to memory.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import router_utility_ref

#: launches of the CUDA kernel since the last reset (``ops.reset_launch_counts``)
COUNTS = {"router_utility": 0}


#: the kernel's function in plain PyTorch — f32 throughout, argmax with the
#: first index on ties — is exactly the oracle's, so it is that function
router_utility_plain = router_utility_ref


@functools.cache
def _bound():
    """(library, entry point), loaded at the first launch and bound once."""
    lib = _build.load("router_utility")
    fn = lib.router_utility_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def router_utility_cuda(h, acc_w, acc_b, cost_w, cost_b, lam):
    """Launch the CUDA kernel. h: (n, dh); heads (dh, M)/(M,), all on one
    CUDA device. Inputs are taken in f32 (as the plain version upcasts;
    f32 contiguous inputs are used as they are, not copied).
    Returns (choice (n,) int32, best (n,) f32)."""
    if not h.is_cuda:
        raise ValueError("router_utility_cuda needs CUDA tensors")
    n, dh = h.shape
    M = acc_w.shape[1]
    if acc_w.shape != (dh, M) or cost_w.shape != (dh, M):
        raise ValueError(f"head weights must be ({dh}, {M}); got "
                         f"{tuple(acc_w.shape)} and {tuple(cost_w.shape)}")
    if acc_b.shape != (M,) or cost_b.shape != (M,):
        raise ValueError(f"head biases must be ({M},)")
    if M < 1:
        raise ValueError("router_utility needs at least one model column")
    args = [t.float().contiguous() for t in (h, acc_w, acc_b, cost_w, cost_b)]
    if any(a.device != h.device for a in args):
        raise ValueError("router_utility inputs must share one device")
    choice = torch.empty((n,), dtype=torch.int32, device=h.device)
    best = torch.empty((n,), dtype=torch.float32, device=h.device)
    lib, fn = _bound()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(*[a.data_ptr() for a in args], float(lam), n, dh, M,
             choice.data_ptr(), best.data_ptr(), stream)
    _build.check(lib, err, "router_utility")
    COUNTS["router_utility"] += 1
    return choice, best
