"""Flash-decoding attention for one query token: the CUDA kernels in
``csrc/decode_attention.cu`` and their plain PyTorch versions.

Replaces the TPU kernels ``repro/kernels/decode_attention.py ::
decode_attention_pallas`` (contiguous head-major cache) and
``paged_decode_attention_pallas`` (page pool addressed through a page
table). One CUDA routine serves both; only the addressing differs.

Dtype discipline (the reference's): q is rounded to the cache dtype
before q·k, scores are f32 and scaled by hd^-0.5, each unnormalized
probability is rounded to the V dtype before p·v, sums are f32, and the
output is in q's dtype. A row with ``n_valid == 0`` is exactly 0;
positions at or past ``n_valid`` are masked. The plain versions below
compute that function in one pass over the valid positions; the kernel
runs it as an online softmax over tiles, so the two differ in the order
of f32 sums and in which running maximum each probability is taken
against before its rounding (see ``chip_smoke.py`` for the bound that
follows).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_gather_ref

#: launches of each CUDA kernel since the last reset
COUNTS = {"decode_attention": 0, "paged_decode_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_G = 8


def _n_valid_vec(n_valid, B: int, device) -> torch.Tensor:
    """n_valid (scalar or (B,)) as a contiguous int32 (B,) tensor."""
    nv = torch.as_tensor(n_valid, dtype=torch.int32, device=device)
    return nv.reshape(-1).expand(B).contiguous()


def decode_attention_plain(q, k_cache, v_cache, n_valid):
    """The kernel's function in plain PyTorch, in one pass: softmax
    against each row's maximum over its valid positions, probabilities
    rounded to the V dtype before p·v, divided by their f32 sum.

    q: (B, Hkv, g, hd); caches (B, Hkv, S, hd); n_valid scalar or (B,).
    Returns (B, Hkv, g, hd) in q's dtype."""
    B, hd = q.shape[0], q.shape[-1]
    S = k_cache.shape[2]
    nv = _n_valid_vec(n_valid, B, q.device)
    valid = (torch.arange(S, device=q.device)[None, :]
             < nv[:, None]).reshape(B, 1, 1, S)
    s = torch.einsum("bhgd,bhkd->bhgk", q.to(k_cache.dtype).float(),
                     k_cache.float()) * hd ** -0.5
    s = torch.where(valid, s, torch.tensor(float("-inf"), device=q.device))
    # a row with no valid position has m = -inf; its p is 0 all the same
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros((), device=q.device))
    acc = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return (acc / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
            ).to(q.dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, n_valid):
    """The paged kernel's function in plain PyTorch: gather each row's
    pages into its logical view, then the contiguous plain version.

    q: (B, Hkv, g, hd); pools (P, Hkv, ps, hd); page_table (B, npg) int32;
    n_valid (B,). Returns (B, Hkv, g, hd) in q's dtype."""
    return decode_attention_plain(q, paged_gather_ref(k_pool, page_table),
                                  paged_gather_ref(v_pool, page_table),
                                  n_valid)


def _check_common(q, k, v, what: str):
    if not q.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q and the caches must be 4-D")
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"{what}: K and V must share shape and dtype")
    B, Hkv, g, hd = q.shape
    if k.shape[1] != Hkv or k.shape[3] != hd:
        raise ValueError(f"{what}: q is {tuple(q.shape)} but the cache is "
                         f"{tuple(k.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {_HEAD_DIMS}")
    if not 1 <= g <= _MAX_G:
        raise ValueError(f"{what}: {g} query rows per kv head; the kernel "
                         f"takes 1..{_MAX_G}")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtypes {q.dtype}/{k.dtype} not in "
                         "float32/bfloat16")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError(f"{what}: inputs must share one device")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: caches must be contiguous")
    return B, Hkv, g, hd


def _fn(name: str):
    lib = _build.load("decode_attention")
    fn = getattr(lib, name)
    n = 4 if name == "decode_attention" else 5  # pointers, then ints
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * n
                   + [ctypes.c_int] * n
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def decode_attention_cuda(q, k_cache, v_cache, n_valid):
    """Launch the contiguous kernel. q: (B, Hkv, g, hd); caches
    (B, Hkv, S, hd) contiguous; n_valid scalar or (B,). Returns
    (B, Hkv, g, hd) in q's dtype."""
    B, Hkv, g, hd = _check_common(q, k_cache, v_cache, "decode_attention")
    if k_cache.shape[0] != B:
        raise ValueError("decode_attention: cache batch differs from q's")
    S = k_cache.shape[2]
    q = q.contiguous()
    nv = _n_valid_vec(n_valid, B, q.device)
    out = torch.empty_like(q)
    lib, fn = _fn("decode_attention")
    err = fn(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype], hd,
             q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             nv.data_ptr(), B, Hkv, g, S, hd ** -0.5, out.data_ptr(),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attention")
    COUNTS["decode_attention"] += 1
    return out


def paged_decode_attention_cuda(q, k_pool, v_pool, page_table, n_valid):
    """Launch the paged kernel. q: (B, Hkv, g, hd); pools (P, Hkv, ps, hd)
    contiguous; page_table (B, npg) of pool page ids, each in [0, P) — the
    kernel does not bound-check them; n_valid (B,). Returns (B, Hkv, g, hd)
    in q's dtype."""
    B, Hkv, g, hd = _check_common(q, k_pool, v_pool, "paged_decode_attention")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError("paged_decode_attention: page_table must be (B, npg)")
    ps, npg = k_pool.shape[2], page_table.shape[1]
    q = q.contiguous()
    pt = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    nv = _n_valid_vec(n_valid, B, q.device)
    out = torch.empty_like(q)
    lib, fn = _fn("paged_decode_attention")
    err = fn(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], hd,
             q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pt.data_ptr(),
             nv.data_ptr(), B, Hkv, g, ps, npg, hd ** -0.5, out.data_ptr(),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "paged_decode_attention")
    COUNTS["paged_decode_attention"] += 1
    return out
