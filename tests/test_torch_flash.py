"""The port's prefill attention (``ops.flash_attention``) against the JAX
reference on the CPU.

Inputs are drawn with numpy from a seed and fed to both sides (bf16 values
rounded identically on both). The port runs its oracle and the plain
version beside the CUDA kernel; the JAX side runs its oracle at the shapes
of tests/test_kernels.py::test_flash_attention and the Pallas kernel in
interpret mode at one shape per dtype. The CUDA kernel itself runs only on
the GPU (chip_smoke.py holds it against the plain version there).

Tolerance: the reference test's own, |Δ| ≤ 2e-5 + 2e-5·|ref| in f32 and
2e-2 + 2e-2·|ref| in bf16 (there both sides round once from f32 values
that differ by f32 summation order, so a value near a rounding boundary
may land one bf16 step apart).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, S, H, hd, dtype, seed):
    """q, k, v as JAX arrays and torch tensors holding the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        a = rng.standard_normal((B, S, H, hd)).astype(np.float32)
        if dtype == "bfloat16":
            b = a.astype(ml_dtypes.bfloat16)
            out.append((jnp.asarray(b), torch.from_numpy(
                b.view(np.int16)).view(torch.bfloat16)))
        else:
            out.append((jnp.asarray(a), torch.from_numpy(a)))
    return [j for j, _ in out], [t for _, t in out]


def _close(got, want, dtype):
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,S,H,hd", [(1, 128, 2, 64), (2, 256, 4, 64),
                                      (2, 512, 2, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_and_oracle_match_jax(B, S, H, hd, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, S, H, hd, dtype, B * S + H)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    _close(tfa.flash_attention_plain(tq, tk, tv, causal=causal), want, dtype)
    _close(ops.flash_attention(tq, tk, tv, causal=causal), want, dtype)
    _close(tref.flash_attention_ref(tq, tk, tv, causal=causal), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_interpret(dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 256, 2, 64, dtype, 7)
    for causal in (True, False):
        want = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=64,
                                      block_k=128, interpret=True)
        _close(ops.flash_attention(tq, tk, tv, causal=causal), want, dtype)


def test_flash_causal_rows_see_only_the_past():
    """Changing the keys and values after position t leaves rows ≤ t as
    they were, bit for bit (the causal mask, not a tolerance)."""
    _, (q, k, v) = _inputs(1, 96, 2, 64, "float32", 3)
    a = ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:] += 1.0
    v2[:, 40:] -= 2.0
    b = ops.flash_attention(q, k2, v2)
    assert torch.equal(a[:, :40], b[:, :40])
    assert not torch.equal(a[:, 40:], b[:, 40:])


def test_flash_cuda_refuses_cpu_tensors_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.delenv("REPRO_TORCH_KERNELS", raising=False)
    q = torch.zeros((1, 16, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q, impl="cuda")
    before = dict(ops.launch_counts())
    assert ops.flash_attention(q, q, q).shape == q.shape   # the plain version
    assert ops.launch_counts() == before
    assert before["flash_attention"] == 0


# ------------------------------------------------- the bf16 kernel's design


def _bf16_ulp(x):
    ax = x.abs().float().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


@pytest.mark.parametrize("causal", [True, False])
def test_pv_split_stays_within_the_chip_tolerance(causal):
    """The bf16 kernel computes p·v as p_hi·v + p_lo·v (p_hi = bf16(p),
    p_lo = bf16(p − p_hi)). On a 4,096-key case that arithmetic stays
    within chip_smoke.py's bf16 tolerance of the plain version, 1 ulp +
    2e-5·A (A = the attention over |v|); rounding p once to bf16 does not,
    which is why the kernel splits p."""
    _, (q, k, v) = _inputs(1, 4096, 1, 64, "bfloat16", 5)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    A = tfa.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                  causal=causal)
    tol = _bf16_ulp(want) + 2e-5 * A
    split = tfa.pv_split_emulation(q, k, v, causal=causal)
    once = tfa.pv_split_emulation(q, k, v, causal=causal, split=False)
    assert split.dtype == once.dtype == torch.bfloat16
    assert ((split.float() - want.float()).abs() <= tol).all()
    assert ((once.float() - want.float()).abs() > tol).any()


@pytest.mark.parametrize("causal", [True, False])
def test_pv_split_error_before_rounding(causal):
    """The same arithmetic before the output's rounding, in f32 on bf16
    values: the split is off the exact p·v by far less than 2e-5·A, one
    rounding of p by more."""
    _, (q, k, v) = _inputs(1, 4096, 1, 64, "bfloat16", 6)
    q, k, v = q.float(), k.float(), v.float()
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    A = tfa.flash_attention_plain(q, k, v.abs(), causal=causal)
    split = tfa.pv_split_emulation(q, k, v, causal=causal)
    once = tfa.pv_split_emulation(q, k, v, causal=causal, split=False)
    assert ((split - want).abs() <= 2e-5 * A).all()
    assert ((once - want).abs() > 2e-5 * A).any()


def _refused(case):
    z = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    if case == "head dim 96":
        t = torch.zeros((1, 16, 2, 96), dtype=torch.bfloat16)
        return (t, t, t), "head dim"
    if case == "mixed dtypes":
        return (z, z.float(), z), "dtypes"
    if case == "float16":
        return (z.half(), z.half(), z.half()), "dtypes"
    if case == "non-contiguous":
        t = torch.zeros((1, 2, 16, 64), dtype=torch.bfloat16).transpose(1, 2)
        return (z, t, z), "contiguous"
    if case == "shapes differ":
        return (z, z[:, :8], z), "shape"
    return (z, z, z), "CUDA"                        # CPU tensors


@pytest.mark.parametrize("case", ["head dim 96", "mixed dtypes", "float16",
                                  "non-contiguous", "shapes differ", "cpu"])
def test_flash_cuda_refuses_what_the_kernels_do_not_take(monkeypatch, case):
    """The wrapper raises before building or launching on what neither
    kernel takes: hd outside (64, 128), mixed or other dtypes,
    non-contiguous inputs, unequal shapes and tensors off the card."""
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", no_build)
    args, match = _refused(case)
    before = dict(ops.launch_counts())
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_cuda(*args)
    assert ops.launch_counts() == before
