"""The PyTorch port's kernel modules against the JAX reference on the CPU.

Inputs are drawn with numpy from a seed and fed to both sides. The JAX
side runs the Pallas kernels in interpret mode, as tests/test_kernels.py
does; the port runs its oracles (``kernels/ref.py``) and the plain
versions that stand beside its CUDA kernels. The CUDA kernels themselves
run only on the GPU (chip_smoke.py holds them against the plain versions
there).

Tolerances: f32 results agree to |Δ| ≤ 1e-5 + 1e-5·|ref|; argmax choices
are equal except on rows whose top-2 utility margin is below 1e-5. For
bf16 caches the port's plain decode (one pass, probabilities rounded to
bf16) is held to the reference test's 2e-2 band against the Pallas kernel
(an online softmax over 128-position blocks), and the port's oracle to
one bf16 rounding step against the JAX oracle.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import (decode_attention_pallas,
                                            paged_decode_attention_pallas)
from repro.kernels.router_utility import router_utility_pallas
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ref as tref
from repro_torch.kernels import router_utility as tru

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounded
    identically on both sides: numpy's ml_dtypes cast, bits viewed)."""
    if dtype == "bfloat16":
        b = a.astype(ml_dtypes.bfloat16)
        return (jnp.asarray(b),
                torch.from_numpy(b.view(np.int16)).view(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _router_inputs(n, dh, M):
    rng = np.random.default_rng(n + M)
    return (rng.standard_normal((n, dh)).astype(np.float32),
            (rng.standard_normal((dh, M)) * 0.05).astype(np.float32),
            (rng.standard_normal((M,)) * 0.1).astype(np.float32),
            (rng.standard_normal((dh, M)) * 0.05).astype(np.float32),
            (rng.standard_normal((M,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("n,dh,M", [(17, 64, 3), (300, 512, 11),
                                    (256, 512, 14), (1024, 128, 40)])
@pytest.mark.parametrize("lam", [0.0, 0.5, 10.0])
def test_router_utility_matches_jax(n, dh, M, lam):
    arrs = _router_inputs(n, dh, M)
    c_j, b_j = router_utility_pallas(*map(jnp.asarray, arrs), lam,
                                     interpret=True)
    c_j, b_j = np.asarray(c_j), np.asarray(b_j)
    h, aw, ab, cw, cb = arrs
    U = 1 / (1 + np.exp(-(h @ aw + ab))) - lam * (h @ cw + cb)
    top2 = np.sort(U, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-5
    tin = [torch.from_numpy(a) for a in arrs]
    for fn in (tref.router_utility_ref, tru.router_utility_plain,
               ops.router_utility):
        c_t, b_t = fn(*tin, lam)
        assert c_t.dtype == torch.int32 and b_t.dtype == torch.float32
        np.testing.assert_allclose(b_t.numpy(), b_j, **F32_TOL)
        diff = c_t.numpy() != c_j
        assert not np.any(diff & ~near_tie), fn


def _decode_inputs(B, Hkv, g, S, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hkv, g, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))]
    return [_both(a, dtype) for a in arrs]


@pytest.mark.parametrize("B,Hkv,g,S,hd", [(1, 2, 4, 256, 64),
                                          (2, 4, 1, 512, 128),
                                          (2, 1, 8, 1024, 64)])
@pytest.mark.parametrize("n_valid_frac", [0.3, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(B, Hkv, g, S, hd, n_valid_frac, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(B, Hkv, g, S, hd, dtype,
                                                  B * S)
    nv = max(1, int(S * n_valid_frac))
    want = _f32(decode_attention_pallas(qj, kj, vj, nv, block_s=128,
                                        interpret=True))
    oracle = _f32(jref.decode_attention_ref(qj, kj, vj, nv))
    plain = tda.decode_attention_plain(qt, kt, vt, nv)
    port_oracle = tref.decode_attention_ref(qt, kt, vt, nv)
    assert plain.dtype == port_oracle.dtype == qt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_f32(plain), want, **F32_TOL)
        np.testing.assert_allclose(_f32(port_oracle), oracle, **F32_TOL)
    else:
        np.testing.assert_allclose(_f32(plain), want, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(_f32(port_oracle), oracle, rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("nv", [[3, 40, 64], [0, 1, 37]])
def test_decode_attention_per_row_n_valid_matches_jax(nv):
    """A (B,) bound per row, fully-invalid rows (n_valid = 0) included:
    those rows are exactly 0 on both sides."""
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(3, 2, 2, 64, 32,
                                                  "float32", 9)
    nvj, nvt = jnp.asarray(nv, jnp.int32), torch.tensor(nv, dtype=torch.int32)
    want = _f32(decode_attention_pallas(qj, kj, vj, nvj, block_s=32,
                                        interpret=True))
    for fn in (tda.decode_attention_plain, tref.decode_attention_ref,
               ops.decode_attention):
        got = _f32(fn(qt, kt, vt, nvt))
        np.testing.assert_allclose(got, want, **F32_TOL)
        for b, n in enumerate(nv):
            if n == 0:
                assert np.all(got[b] == 0.0)


def _paged_inputs(B, Hkv, g, ps, npg, P, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hkv, g, 32), (P, Hkv, ps, 32), (P, Hkv, ps, 32))]
    # entries may name page 0 (the trash page); short bounds mask them
    pt = rng.integers(0, P, size=(B, npg)).astype(np.int32)
    nv = rng.integers(0, npg * ps + 1, size=(B,)).astype(np.int32)
    nv[0] = 0
    return arrs, pt, nv


@pytest.mark.parametrize("B,Hkv,g,ps,npg,P", [(2, 2, 2, 8, 4, 12),
                                              (3, 1, 4, 16, 2, 5),
                                              (1, 2, 1, 32, 3, 4)])
def test_paged_decode_attention_matches_jax(B, Hkv, g, ps, npg, P):
    (q, kp, vp), pt, nv = _paged_inputs(B, Hkv, g, ps, npg, P,
                                        B * ps + npg)
    want = _f32(paged_decode_attention_pallas(
        *map(jnp.asarray, (q, kp, vp, pt, nv)), interpret=True))
    tin = [torch.from_numpy(a) for a in (q, kp, vp, pt, nv)]
    for fn in (tda.paged_decode_attention_plain,
               tref.paged_decode_attention_ref,
               tref.paged_decode_attention_seg_ref,
               ops.paged_decode_attention):
        got = _f32(fn(*tin))
        np.testing.assert_allclose(got, want, **F32_TOL)
        assert np.all(got[0] == 0.0)


def test_paged_gather_and_seg_ref_match_jax():
    (q, kp, vp), pt, nv = _paged_inputs(4, 2, 1, 8, 3, 6, 1)
    np.testing.assert_array_equal(
        tref.paged_gather_ref(torch.from_numpy(kp),
                              torch.from_numpy(pt)).numpy(),
        np.asarray(jref.paged_gather_ref(jnp.asarray(kp), jnp.asarray(pt))))
    # a table naming the same page in every entry counts it with
    # multiplicity on both sides
    pt_dup = np.tile(pt[:, :1], (1, pt.shape[1]))
    for table in (pt, pt_dup):
        want = np.asarray(jref.paged_decode_attention_seg_ref(
            *map(jnp.asarray, (q, kp, vp, table, nv))))
        got = tref.paged_decode_attention_seg_ref(
            *[torch.from_numpy(a) for a in (q, kp, vp, table, nv)])
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_plain_decode_rows_do_not_depend_on_other_rows():
    """A row's plain result does not depend on the other rows' bounds."""
    (_, q), (_, k), (_, v) = _decode_inputs(3, 2, 3, 96, 64, "bfloat16", 4)
    nv = torch.tensor([5, 96, 40], dtype=torch.int32)
    full = tda.decode_attention_plain(q, k, v, nv)
    for b in range(3):
        row = tda.decode_attention_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                         nv[b:b + 1])
        assert torch.equal(row[0], full[b])


def test_ops_dispatch_on_cpu(monkeypatch):
    """CPU tensors take the plain version; asking for the kernel on CPU
    tensors raises, by argument or by environment — never a silent
    fallback."""
    monkeypatch.delenv("REPRO_TORCH_KERNELS", raising=False)
    x = torch.zeros((2, 4))
    assert ops.resolve_impl(None, x) == "ref"
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_impl("cuda", x)
    with pytest.raises(ValueError, match="impl"):
        ops.resolve_impl("pallas", x)
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.router_utility(x, torch.zeros((4, 2)), torch.zeros(2),
                           torch.zeros((4, 2)), torch.zeros(2), 0.5)


def test_cuda_wrappers_refuse_cpu_tensors_without_building():
    q = torch.zeros((1, 1, 1, 64))
    c = torch.zeros((1, 1, 16, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention_cuda(q, c, c, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tda.paged_decode_attention_cuda(q, c, c, torch.zeros((1, 1)), 4)
    with pytest.raises(ValueError, match="CUDA"):
        tru.router_utility_cuda(torch.zeros((2, 4)), torch.zeros((4, 2)),
                                torch.zeros(2), torch.zeros((4, 2)),
                                torch.zeros(2), 0.5)
    assert not _build._libs          # importing and refusing built nothing
    assert ops.launch_counts() == {"router_utility": 0,
                                   "decode_attention": 0,
                                   "paged_decode_attention": 0,
                                   "kmeans_assign": 0,
                                   "kmeans_assign_reduce": 0}
