"""Prefill (flash) attention: the CUDA kernel ``csrc/flash_attention.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py ::
flash_attention_pallas``. q, k, v are (B, S, H, hd) with equal head
counts; the result is softmax(q·kᵀ·hd^-0.5)·v in q's dtype, causal or not.

Dtype discipline (the reference's, which differs from the decode
kernels'): q and k are upcast to f32 before the dot, the causal mask is
-1e30, the softmax, its normalizer and p·v are f32 with v upcast and p
never rounded as a whole, and the output is rounded once to q's dtype.
The plain version computes that in one pass. The kernel runs it as an
online softmax over key tiles: bf16 inputs on the tensor cores, with p·v
taken as p_hi·v + p_lo·v where p_hi = bf16(p) and p_lo = bf16(p − p_hi)
(``pv_split_emulation`` is that arithmetic in plain PyTorch); f32 inputs
on the CUDA cores. So the two differ by the order of f32 sums and, in
bf16, by the < 2^-17 of p that p_hi + p_lo drops (``chip_smoke.py`` states
the bound that follows).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

#: launches of the CUDA kernel since the last reset
COUNTS = {"flash_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

#: the kernel's function in plain PyTorch is exactly the oracle's
flash_attention_plain = flash_attention_ref


def pv_split_emulation(q, k, v, *, causal: bool = True, split: bool = True):
    """The bf16 kernel's p·v arithmetic in plain PyTorch (for tests): p in
    f32 from the f32 scores, then p·v as p_hi·v + p_lo·v with p_hi =
    bf16(p) and p_lo = bf16(p − p_hi), each product of two bf16 values
    exact in f32. ``split=False`` rounds p once to bf16 instead, the
    shortcut the kernel does not take. Returns (B, S, H, hd) in q's
    dtype."""
    hd = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        S = q.shape[1]
        m = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
        s = torch.where(m, s, torch.tensor(-1e30, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    hi = p.to(torch.bfloat16).float()
    parts = [hi, (p - hi).to(torch.bfloat16).float()] if split else [hi]
    out = sum(torch.einsum("bhqk,bkhd->bhqd", part, v.float())
              for part in parts)
    return (out / l).transpose(1, 2).to(q.dtype)


def _fn():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """Launch the CUDA kernel. q, k, v: contiguous (B, S, H, hd) CUDA
    tensors of one dtype (f32 or bf16), hd 64 or 128. Returns
    (B, S, H, hd) in q's dtype."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, S, H, hd); got "
                         f"{tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} (repeat GQA heads first)")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes one of float32, "
                         "bfloat16 for all three")
    B, S, H, hd = q.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {_HEAD_DIMS}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention: inputs must share one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k, v must start on a "
                         "16-byte boundary (the kernel reads them with TMA)")
    out = torch.empty_like(q)
    lib, fn = _fn()
    err = fn(_DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), B, S, H, int(bool(causal)), hd ** -0.5,
             out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    COUNTS["flash_attention"] += 1
    return out
