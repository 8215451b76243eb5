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
