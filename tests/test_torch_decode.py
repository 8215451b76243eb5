"""The decode kernels' split arithmetic on the CPU: ``decode_split_emulation``
(plain PyTorch that runs the CUDA kernels' chunking) against the port's
plain version and the JAX reference's Pallas kernel in interpret mode.

Inputs are drawn with numpy from a seed and fed to both sides (bf16 values
rounded identically on both). The tolerance is chip_smoke.py's own
``check_close``, the one the CUDA kernels are held to on the card: 2 bf16
ulps of the reference value plus (2^-8 + 1e-5)·A, A the attention of the
same query over |v| (the bound on rounding each probability to bf16
against its chunk's maximum instead of the row's); f32 outputs to 1e-5 +
1e-5·|ref|. The kernel's chunk size, 32, and the two it was measured
against, 64 and 128, are checked. The head dims the kernels run padded
(80 as hubert's and 112 as kimi-k2's, both through the width-128 build)
are checked at the kernel's chunk size. The wrappers' refusals are checked
without building anything.
"""
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CHUNKS = (32, 64, 128)
B, HKV, G, S, HD = 4, 2, 8, 4096, 128


def _both(a: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        b = a.astype(ml_dtypes.bfloat16)
        return (jnp.asarray(b),
                torch.from_numpy(b.view(np.int16)).view(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _n_valid(case: str, rng) -> np.ndarray:
    if case == "full":
        return np.full((B,), S, np.int32)
    nv = rng.integers(1, S + 1, (B,)).astype(np.int32)
    if case == "zeros":
        nv[0] = nv[B // 2] = 0
    return nv


@functools.lru_cache(maxsize=None)
def _case(case: str, dtype: str = "bfloat16", s: int = S, hd: int = HD):
    """(q, k, v, n_valid) as torch tensors, the port's plain result, the
    scale A for the tolerance (bf16 caches) and the Pallas result."""
    rng = np.random.default_rng(("full", "ragged", "zeros").index(case))
    arrs = [_both(rng.standard_normal(shape).astype(np.float32), dtype)
            for shape in ((B, HKV, G, hd), (B, HKV, s, hd), (B, HKV, s, hd))]
    nv = np.minimum(_n_valid(case, rng), s)
    (qj, q), (kj, k), (vj, v) = arrs
    nvt = torch.from_numpy(nv)
    plain = tda.decode_attention_plain(q, k, v, nvt)
    scale = (tda.decode_attention_plain(q.float(), k, v.abs(), nvt)
             if dtype == "bfloat16" else None)
    pallas = np.array(decode_attention_pallas(
        qj, kj, vj, jnp.asarray(nv), block_s=512, interpret=True), np.float32)
    return (q, k, v, nvt), plain, scale, pallas


@pytest.mark.parametrize("case", ["full", "ragged", "zeros"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_emulation_within_chip_tolerance(chunk, case):
    """bf16, S 4096: the split arithmetic stays within chip_smoke's
    tolerance of the plain version and of the Pallas kernel; rows with
    n_valid 0 are exactly 0."""
    args, plain, scale, pallas = _case(case)
    got = tda.decode_split_emulation(*args, chunk=chunk)
    chip_smoke.check_close(torch, got, plain, f"emulation C={chunk} {case} "
                           "vs plain", scale)
    chip_smoke.check_close(torch, got, torch.from_numpy(pallas).to(got.dtype),
                           f"emulation C={chunk} {case} vs Pallas", scale)
    nv = args[3]
    assert torch.equal(got[nv == 0], torch.zeros_like(got[nv == 0]))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_emulation_f32_within_chip_tolerance(chunk):
    """f32 caches: p is not rounded, so only the order of f32 sums and the
    factored exponentials differ from the plain version and Pallas."""
    args, plain, scale, pallas = _case("zeros", "float32", 1024)
    assert scale is None
    got = tda.decode_split_emulation(*args, chunk=chunk)
    chip_smoke.check_close(torch, got, plain, f"f32 C={chunk} vs plain")
    chip_smoke.check_close(torch, got, torch.from_numpy(pallas),
                           f"f32 C={chunk} vs Pallas")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [80, 112])
def test_split_emulation_at_padded_head_dims(hd, dtype):
    """hd 80 and 112 at the kernel's chunk size, S 1024 with rows at
    n_valid 0: within chip_smoke's tolerance of the plain version and of
    the Pallas kernel; the scale is the true hd^-0.5."""
    args, plain, scale, pallas = _case("zeros", dtype, 1024, hd)
    got = tda.decode_split_emulation(*args, chunk=32)
    assert got.shape == (B, HKV, G, hd)
    chip_smoke.check_close(torch, got, plain, f"hd {hd} {dtype} vs plain",
                           scale)
    chip_smoke.check_close(torch, got, torch.from_numpy(pallas).to(got.dtype),
                           f"hd {hd} {dtype} vs Pallas", scale)
    nv = args[3]
    assert torch.equal(got[nv == 0], torch.zeros_like(got[nv == 0]))


def _paged_copy(k, v, nv, ps: int, npg: int, rng):
    """The first npg*ps logical positions of each row in shuffled pages of
    a pool; pages past a row's bound, and page 0 (the trash page), are NaN,
    and so is every position at or past n_valid."""
    Bn, Hkv, _, hd = k.shape
    P = Bn * npg + 1
    pt = (rng.permutation(P - 1)[:Bn * npg].reshape(Bn, npg) + 1).astype(
        np.int32)
    pt[np.arange(npg)[None, :] * ps >= nv.numpy()[:, None]] = 0
    pools = []
    for t in (k, v):
        pool = torch.full((P, Hkv, ps, hd), float("nan"), dtype=t.dtype)
        for b in range(Bn):
            for i in range(npg):
                lo = i * ps
                n_here = int(min(max(int(nv[b]) - lo, 0), ps))
                if pt[b, i] and n_here:
                    pool[pt[b, i], :, :n_here] = t[b, :, lo:lo + n_here]
        pools.append(pool)
    return pools, torch.from_numpy(pt)


@pytest.mark.parametrize("ps,npg", [(16, 260), (8, 600)])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_paged_split_emulation_equals_contiguous_bitwise(chunk, ps, npg):
    """The paged emulation equals the contiguous one bit for bit on the same
    logical contents, whatever S, npg and the page order, with NaN in every
    position that must not be read."""
    _paged_equals_contiguous(_case("zeros")[0], chunk, ps, npg)


def test_paged_split_emulation_equals_contiguous_bitwise_at_hd_112():
    """The same at kimi-k2's head dim and the kernel's chunk size."""
    _paged_equals_contiguous(_case("zeros", "bfloat16", 1024, 112)[0], 32,
                             16, 64)


def _paged_equals_contiguous(args, chunk, ps, npg):
    q, k, v, nv = args
    S = k.shape[2]
    rng = np.random.default_rng(chunk + npg)
    nv = torch.minimum(nv, torch.tensor(npg * ps, dtype=torch.int32))
    (kp, vp), pt = _paged_copy(k, v, nv, ps, npg, rng)
    past = (torch.arange(S)[None, :] >= nv[:, None]).reshape(B, 1, S, 1)
    kn, vn = (torch.where(past, torch.tensor(float("nan"), dtype=t.dtype), t)
              for t in (k, v))
    want = tda.decode_split_emulation(q, kn, vn, nv, chunk=chunk)
    got = tda.paged_decode_split_emulation(q, kp, vp, pt, nv, chunk=chunk)
    assert torch.isfinite(want.float()).all()
    assert torch.equal(got, want)


def _refused(fn, match: str):
    with pytest.raises(ValueError, match=match):
        fn()


@pytest.mark.parametrize("bad", ["hd96", "hd72", "hd136", "g9", "kv_dtypes",
                                 "noncontig", "unaligned", "page_table",
                                 "f16"])
def test_decode_wrappers_refuse_bad_inputs_without_building(bad):
    """Every input the kernels do not take raises before anything is built
    or launched (checked on CPU tensors: shape, dtype, layout and alignment
    come before the device). The head dim must be a multiple of 16 from 16
    to 128: 72 and 136 are refused for it; 96 passes that check and is
    refused only for lying on the CPU."""
    q = torch.zeros((2, 1, 4, 64))
    k = torch.zeros((2, 1, 32, 64))
    v = torch.zeros((2, 1, 32, 64))
    pt = torch.zeros((2, 2), dtype=torch.int32)
    match = {"hd96": "needs CUDA", "hd72": "head dim", "hd136": "head dim",
             "g9": "query rows", "kv_dtypes": "share",
             "noncontig": "contiguous", "unaligned": "16-byte",
             "page_table": "page_table", "f16": "dtypes"}[bad]
    if bad.startswith("hd"):
        hd = int(bad[2:])
        q = torch.zeros((2, 1, 4, hd))
        k, v = torch.zeros((2, 1, 32, hd)), torch.zeros((2, 1, 32, hd))
    elif bad == "g9":
        q = torch.zeros((2, 1, 9, 64))
    elif bad == "kv_dtypes":
        v = v.to(torch.bfloat16)
    elif bad == "noncontig":
        k = torch.zeros((2, 1, 64, 32)).transpose(2, 3)
        v = torch.zeros((2, 1, 64, 32)).transpose(2, 3)
    elif bad == "unaligned":
        k = torch.zeros(k.numel() + 1)[1:].view(k.shape)
    elif bad == "f16":
        q, k, v = q.half(), k.half(), v.half()
    if bad != "page_table":
        _refused(lambda: tda.decode_attention_cuda(q, k, v, 4), match)
    _refused(lambda: tda.paged_decode_attention_cuda(
        q, k, v, pt[:1] if bad == "page_table" else pt, 4), match)
    assert not _build._libs
    assert tda.COUNTS == {"decode_attention": 0, "paged_decode_attention": 0}
