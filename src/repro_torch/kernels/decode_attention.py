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
compute that function in one pass over the valid positions. The kernel
splits the sequence into chunks of ``chunk`` logical positions, one block
each: a block takes every probability of its chunk against the chunk's
maximum, rounds it to the V dtype there, and writes f32 partials
(m, l, acc); a second launch merges them in chunk order. Over a bf16
cache both products run on the tensor cores (bf16 in, f32 sums). So the two
differ in the order of f32 sums and in which maximum each probability is
rounded against (see ``chip_smoke.py`` for the bound that follows);
``decode_split_emulation`` is the kernel's arithmetic in plain PyTorch.

The kernels take every head dim that is a multiple of 16 from 16 to 128:
they are compiled for the padded widths 64 and 128, take the true head dim
at run time and read no column past it. Any other head dim, and more than
8 query rows per kv head, raises (no config in the repo needs more).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_gather_ref

#: launches of each CUDA kernel since the last reset
COUNTS = {"decode_attention": 0, "paged_decode_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = tuple(range(16, 129, 16))
_MAX_G = 8


def _padded(hd: int) -> int:
    """The width the kernel is compiled for: 64, or 128 above 64."""
    return 64 if hd <= 64 else 128


def _n_valid_vec(n_valid, B: int, device) -> torch.Tensor:
    """n_valid (scalar or (B,)) as a contiguous int32 (B,) tensor; one
    that already is one is returned as it is."""
    if (isinstance(n_valid, torch.Tensor) and n_valid.dtype == torch.int32
            and n_valid.device == device and n_valid.shape == (B,)
            and n_valid.is_contiguous()):
        return n_valid
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


def decode_split_emulation(q, k_cache, v_cache, n_valid, *, chunk: int):
    """The kernels' split arithmetic in plain PyTorch (for tests): chunks
    of ``chunk`` logical positions, each with its own maximum m_c, its
    probabilities exp(s − m_c) rounded to the V dtype against it and f32
    partials l_c = Σ p, acc_c = Σ round(p)·v; then the merge in chunk
    order by the online rule (m, l, a) ← (m', l·e + l_c·e_c, a·e +
    acc_c·e_c), m' = max(m, m_c), e = exp(m − m'), e_c = exp(m_c − m'),
    and out = a / max(l, 1e-30). Positions past n_valid are zeroed before
    use, and every chunk is computed at one shape, so the result depends
    on the logical contents and n_valid only, never on S. Same arguments
    and result as ``decode_attention_plain``."""
    B, Hkv, g, hd = q.shape
    S = k_cache.shape[2]
    nv = _n_valid_vec(n_valid, B, q.device).clamp(0, S)
    n_chunks = int(((nv + chunk - 1) // chunk).max()) if B else 0
    qf = q.to(k_cache.dtype).float()
    ninf = torch.tensor(float("-inf"), device=q.device)
    zero = torch.zeros((), device=q.device)
    parts = []                                  # (has, m_c, l_c, acc_c)
    for c in range(n_chunks):
        pos = c * chunk + torch.arange(chunk, device=q.device)
        valid = pos[None, :] < nv[:, None]                    # (B, chunk)
        kv = []
        for t in (k_cache, v_cache):
            t = t[:, :, c * chunk:(c + 1) * chunk].float()
            t = F.pad(t, (0, 0, 0, chunk - t.shape[2]))
            kv.append(torch.where(valid[:, None, :, None], t, zero))
        s = torch.einsum("bhgd,bhkd->bhgk", qf, kv[0]) * hd ** -0.5
        s = torch.where(valid[:, None, None, :], s, ninf)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid[:, None, None, :], torch.exp(s - m), zero)
        acc = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(),
                           kv[1])
        parts.append((valid[:, 0].reshape(B, 1, 1, 1), m,
                      p.sum(dim=-1, keepdim=True), acc))
    m = torch.full((B, Hkv, g, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, Hkv, g, 1), device=q.device)
    o = torch.zeros((B, Hkv, g, hd), device=q.device)
    for has, mc, lc, acc in parts:      # a row's chunks with data: a prefix
        mn = torch.maximum(m, mc)
        e, ec = torch.exp(m - mn), torch.exp(mc - mn)
        l = torch.where(has, l * e + lc * ec, l)
        o = torch.where(has, o * e + acc * ec, o)
        m = torch.where(has, mn, m)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def paged_decode_split_emulation(q, k_pool, v_pool, page_table, n_valid, *,
                                 chunk: int):
    """``decode_split_emulation`` on each row's gathered logical view: the
    paged kernels' arithmetic, equal bit for bit to the contiguous
    emulation on the same logical contents."""
    return decode_split_emulation(q, paged_gather_ref(k_pool, page_table),
                                  paged_gather_ref(v_pool, page_table),
                                  n_valid, chunk=chunk)


def _check_common(q, k, v, what: str, page_table=None):
    """Refuse what the kernels do not take, layout before device; caches
    are (B, Hkv, S, hd), or pools with a (B, npg) ``page_table``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q and the caches must be 4-D")
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"{what}: K and V must share shape and dtype")
    B, Hkv, g, hd = q.shape
    if k.shape[1] != Hkv or k.shape[3] != hd:
        raise ValueError(f"{what}: q is {tuple(q.shape)} but the cache is "
                         f"{tuple(k.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd}; the kernel takes a "
                         "multiple of 16 from 16 to 128")
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
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{what}: caches must start on a 16-byte boundary "
                         "(the kernel reads them 16 bytes a lane)")
    if page_table is None and k.shape[0] != B:
        raise ValueError(f"{what}: cache batch differs from q's")
    if page_table is not None and (page_table.dim() != 2
                                   or page_table.shape[0] != B):
        raise ValueError(f"{what}: page_table must be (B, npg)")
    if not q.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors")
    return B, Hkv, g, hd


class _Bound(NamedTuple):
    """The loaded library, its two entry points and its chunk size."""
    lib: ctypes.CDLL
    contig: Callable[..., int]
    paged: Callable[..., int]
    chunk: int


@functools.cache
def _bound() -> _Bound:
    """Load the library at the first launch and bind its entry points
    once."""
    lib = _build.load("decode_attention")
    fns = []
    for name, n in (("decode_attention", 4), ("paged_decode_attention", 5)):
        fn = getattr(lib, name)
        # dtype codes and hd; n pointers, then n ints; scale; workspace,
        # out, stream
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * n
                       + [ctypes.c_int] * n + [ctypes.c_float]
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        fns.append(fn)
    lib.decode_attention_chunk.restype = ctypes.c_int
    return _Bound(lib, *fns, lib.decode_attention_chunk())


def _workspace(B: int, Hkv: int, g: int, hd: int, cap: int, chunk: int,
               device) -> torch.Tensor:
    """f32 partials (m, l, acc) of every (row, kv head, chunk), at the
    padded head dim."""
    n_chunks = -(-cap // chunk)
    return torch.empty(B * Hkv * n_chunks * g * (_padded(hd) + 2),
                       dtype=torch.float32, device=device)


def decode_attention_cuda(q, k_cache, v_cache, n_valid):
    """Launch the contiguous kernel. q: (B, Hkv, g, hd); caches
    (B, Hkv, S, hd) contiguous and 16-byte aligned; n_valid scalar or
    (B,). Returns (B, Hkv, g, hd) in q's dtype."""
    B, Hkv, g, hd = _check_common(q, k_cache, v_cache, "decode_attention")
    S = k_cache.shape[2]
    q = q.contiguous()
    nv = _n_valid_vec(n_valid, B, q.device)
    out = torch.empty_like(q)
    bd = _bound()
    ws = _workspace(B, Hkv, g, hd, S, bd.chunk, q.device)
    err = bd.contig(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype], hd,
                    q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    nv.data_ptr(), B, Hkv, g, S, hd ** -0.5, ws.data_ptr(),
                    out.data_ptr(),
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(bd.lib, err, "decode_attention")
    COUNTS["decode_attention"] += 1
    return out


def paged_decode_attention_cuda(q, k_pool, v_pool, page_table, n_valid):
    """Launch the paged kernel. q: (B, Hkv, g, hd); pools (P, Hkv, ps, hd)
    contiguous and 16-byte aligned; page_table (B, npg) of pool page ids,
    each in [0, P) — the kernel does not bound-check them; n_valid (B,).
    Returns (B, Hkv, g, hd) in q's dtype."""
    B, Hkv, g, hd = _check_common(q, k_pool, v_pool, "paged_decode_attention",
                                  page_table)
    ps, npg = k_pool.shape[2], page_table.shape[1]
    q = q.contiguous()
    pt = page_table
    if (pt.dtype != torch.int32 or pt.device != q.device
            or not pt.is_contiguous()):
        pt = pt.to(device=q.device, dtype=torch.int32).contiguous()
    nv = _n_valid_vec(n_valid, B, q.device)
    out = torch.empty_like(q)
    bd = _bound()
    ws = _workspace(B, Hkv, g, hd, npg * ps, bd.chunk, q.device)
    err = bd.paged(_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], hd,
                   q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   pt.data_ptr(), nv.data_ptr(), B, Hkv, g, ps, npg,
                   hd ** -0.5, ws.data_ptr(), out.data_ptr(),
                   torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(bd.lib, err, "paged_decode_attention")
    COUNTS["paged_decode_attention"] += 1
    return out
