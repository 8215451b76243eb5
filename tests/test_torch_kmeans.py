"""The port's K-means path against the JAX reference on the CPU.

Inputs are drawn with numpy from a seed and fed to both sides. The kernel
modules: ``kmeans_assign_plain`` / ``kmeans_assign_reduce_plain`` (the
plain versions beside the CUDA kernels) against the reference oracles on
the parametrisations of ``tests/test_kernels.py``, and on small shapes
against the Pallas kernels in interpret mode. Then Lloyd from the
reference's own k-means++ seeds, the cluster statistics from the
reference's own global centroids, and the federated fit's frontier AUC.

Tolerances, stated per check:
  * assignments equal, except on rows whose top-2 distance gap (computed
    in f64) is below 1e-5 × (|‖μ‖²| + 2|x·μ|) at the winner — there the
    two sides' f32 products may round either way;
  * sums to |Δ| ≤ 1e-5 + 1e-5·|ref| (the reference test's band), counts
    exact for 0/1 weights and to 1e-5 for uniform ones;
  * Lloyd centroids to 1e-5 after 30 iterations;
  * cluster statistics: counts exact, A and C to 1e-6;
  * the federated K-means fit: mean frontier AUC over 8 seeds within 0.02
    of the reference's mean over 8 keys (one fit's AUC spreads by ~0.02
    across seeds on either side).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JFedConfig
from repro.config import RouterConfig as JRouterConfig
from repro.core import kmeans as JK
from repro.core import kmeans_router as JKR
from repro.core import policy as JP
from repro.data.partition import federated_split as jfederated_split
from repro.data.synthetic import make_eval_corpus as jmake_eval_corpus
from repro.kernels import ref as jref
from repro.kernels.kmeans_assign import (kmeans_assign_pallas,
                                         kmeans_assign_reduce_pallas)
from repro import routers as jrouters
from repro_torch import convert, routers
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.core import kmeans as TK
from repro_torch.core import kmeans_router as TKR
from repro_torch.core import policy as TP
from repro_torch.kernels import _build, ops
from repro_torch.kernels import kmeans_assign as tkm
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounded
    identically on both sides)."""
    if dtype == "bfloat16":
        b = a.astype(ml_dtypes.bfloat16)
        return (jnp.asarray(b),
                torch.from_numpy(b.view(np.int16)).view(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _near_ties(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Rows whose top-2 gap of ‖μ‖² − 2x·μ is below 1e-5 × (|‖μ‖²| +
    2|x·μ|) at the winner, in f64 from the (rounded) inputs."""
    x, c = x.astype(np.float64), c.astype(np.float64)
    xc = x @ c.T
    c2 = (c * c).sum(-1)
    dist = c2[None] - 2 * xc
    win = dist.argmin(-1)
    srt = np.sort(dist, axis=-1)
    gap = (srt[:, 1] - srt[:, 0]) if c.shape[0] > 1 else np.full(len(x), np.inf)
    r = np.arange(len(x))
    return gap < 1e-5 * (np.abs(c2[win]) + 2 * np.abs(xc[r, win]))


def _assert_assign(got, want, x, c):
    got, want = np.asarray(got), np.asarray(want)
    bad = (got != want) & ~_near_ties(np.asarray(x, np.float32),
                                       np.asarray(c, np.float32))
    assert not bad.any(), f"{int(bad.sum())} rows assigned differently"


def _f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ------------------------------------------------------------ kernel modules


@pytest.mark.parametrize("n,d,K", [(64, 8, 3), (513, 77, 13), (1000, 128, 20),
                                   (256, 768, 15), (37, 33, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assign_plain_matches_reference(n, d, K, dtype):
    rng = np.random.default_rng(n + d)
    xj, xt = _both(rng.standard_normal((n, d)).astype(np.float32), dtype)
    cj, ct = _both(rng.standard_normal((K, d)).astype(np.float32), dtype)
    want = np.asarray(jref.kmeans_assign_ref(xj, cj))
    got = tkm.kmeans_assign_plain(xt, ct)
    assert got.dtype == torch.int32 and got.shape == (n,)
    _assert_assign(got.numpy(), want, _f32(xt), _f32(ct))
    _assert_assign(tref.kmeans_assign_ref(xt, ct).numpy(), want, _f32(xt),
                   _f32(ct))
    if n <= 64:   # the Pallas kernel in interpret mode, on the small shapes
        _assert_assign(got.numpy(),
                       np.asarray(kmeans_assign_pallas(xj, cj,
                                                       interpret=True)),
                       _f32(xt), _f32(ct))


@pytest.mark.parametrize("n,d,K", [(64, 8, 3), (513, 77, 13), (256, 128, 20),
                                   (100, 40, 130), (300, 24, 2000),
                                   (100, 4096, 40), (257, 999, 13)])
def test_assign_reduce_plain_matches_reference(n, d, K):
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((K, d)).astype(np.float32)
    w = rng.uniform(size=(n,)).astype(np.float32)
    a_j, s_j, n_j = jref.kmeans_assign_reduce_ref(*map(jnp.asarray, (x, c, w)))
    a_t, s_t, n_t = tkm.kmeans_assign_reduce_plain(*map(torch.from_numpy,
                                                        (x, c, w)))
    assert (a_t.dtype, s_t.dtype, n_t.dtype) == (torch.int32, torch.float32,
                                                 torch.float32)
    _assert_assign(a_t.numpy(), np.asarray(a_j), x, c)
    # the reduction is held against the oracle's reduction of the port's
    # own assignment (a near-tie row may legally sit in either cluster)
    onehot = np.eye(K, dtype=np.float32)[a_t.numpy()] * w[:, None]
    np.testing.assert_allclose(s_t.numpy(), onehot.T @ x, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(n_t.numpy(), onehot.sum(0), rtol=1e-5,
                               atol=1e-5)
    if n == 64:   # the fused Pallas kernel in interpret mode
        a_p, s_p, n_p = kmeans_assign_reduce_pallas(
            *map(jnp.asarray, (x, c, w)), interpret=True)
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_p))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_p), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(n_t.numpy(), np.asarray(n_p), rtol=1e-5,
                                   atol=1e-5)


def _emulation_case(case):
    """(x (G, n, d), cents (G·R, K, d), w (G, n)) of one edge case of the
    reduction kernel's segments and tree."""
    S = tkm.REDUCE_SEG
    rng = np.random.default_rng(len(case))
    G, R, n, d, K, wkind = {
        "n = S - 1": (1, 1, S - 1, 8, 5, "uniform"),
        "n = S": (1, 1, S, 8, 5, "uniform"),
        "n = S + 1": (1, 1, S + 1, 8, 5, "uniform"),
        "n = 2S + 1": (1, 1, 2 * S + 1, 8, 5, "uniform"),
        "n = 1": (1, 1, 1, 8, 5, "uniform"),
        "one cluster takes every row": (1, 1, 2 * S + 1, 6, 4, "uniform"),
        "empty clusters": (1, 1, S + 1, 6, 12, "uniform"),
        "all weights zero": (1, 1, S + 1, 6, 4, "zero"),
        "0/1 weights": (1, 1, 2 * S + 1, 7, 6, "01"),
        "G x R batches": (2, 3, S + 1, 9, 5, "01"),
        "R·K > 64": (2, 3, S + 1, 5, 30, "uniform"),
    }[case]
    x = rng.standard_normal((G, n, d)).astype(np.float32)
    c = rng.standard_normal((G * R, K, d)).astype(np.float32)
    if case == "one cluster takes every row":
        c *= 100.0
        c[:, 0] = 0.0
    if case == "empty clusters":
        c[:, 6:] *= 100.0
    w = {"uniform": rng.uniform(size=(G, n)),
         "zero": np.zeros((G, n)),
         "01": rng.uniform(size=(G, n)) > 0.3}[wkind].astype(np.float32)
    return x, c, w


def _cluster_abs(a, x, w, K):
    """Σ|w·x| of each cluster of the assignment a (n,): (K, d)."""
    onehot = np.eye(K, dtype=np.float32)[a] * w[:, None]
    return onehot.T @ np.abs(x)


@pytest.mark.parametrize("case", [
    "n = S - 1", "n = S", "n = S + 1", "n = 2S + 1", "n = 1",
    "one cluster takes every row", "empty clusters", "all weights zero",
    "0/1 weights", "G x R batches", "R·K > 64"])
def test_segmented_emulation_matches_plain_and_reference(case):
    """The reduction kernel's order (segments of 256 rows, each cluster's
    rows in row order, the segments' partials added in groups of 16) in
    plain PyTorch, against the one-hot plain version and, per problem,
    the JAX reference oracle (and, for one segment, the Pallas kernel in
    interpret mode): sums to |Δ| ≤ 1e-5 × Σ|w·x| of the cluster (two f32
    orders of the same sum), counts exact for 0/1 weights and to 1e-5
    otherwise, assignments equal; absent clusters sum to exactly 0."""
    x, c, w = _emulation_case(case)
    G, n, d = x.shape
    P, K, _ = c.shape
    R = P // G
    xt, ct, wt = map(torch.from_numpy, (x, c, w))
    a_e, s_e, n_e = tkm.kmeans_reduce_segmented_emulation(xt, ct, wt)
    a_p, s_p, n_p = tkm.kmeans_assign_reduce_plain(xt, ct, wt)
    assert (a_e.shape, s_e.shape, n_e.shape) == ((P, n), (P, K, d), (P, K))
    assert s_e.dtype == n_e.dtype == torch.float32
    np.testing.assert_array_equal(a_e.numpy(), a_p.numpy())
    exact = case in ("0/1 weights", "G x R batches", "all weights zero")
    for p in range(P):
        a = a_e[p].numpy()
        scale = _cluster_abs(a, x[p // R], w[p // R], K)
        a_j, s_j, n_j = jref.kmeans_assign_reduce_ref(
            jnp.asarray(x[p // R]), jnp.asarray(c[p]), jnp.asarray(w[p // R]))
        _assert_assign(a, np.asarray(a_j), x[p // R], c[p])
        for want, cnt in ((s_p[p].numpy(), n_p[p].numpy()),
                          (np.asarray(s_j), np.asarray(n_j))):
            assert np.all(np.abs(s_e[p].numpy() - want) <= 1e-5 * scale)
            if exact:
                np.testing.assert_array_equal(n_e[p].numpy(), cnt)
            else:
                np.testing.assert_allclose(n_e[p].numpy(), cnt, rtol=1e-5,
                                           atol=1e-6)
        absent = np.bincount(a[w[p // R] != 0], minlength=K) == 0
        assert np.all(s_e[p].numpy()[absent] == 0.0)
        assert np.all(n_e[p].numpy()[absent] == 0.0)
    if case == "all weights zero":
        assert not s_e.abs().sum() and not n_e.abs().sum()
    if case == "one cluster takes every row":
        assert np.all(n_e.numpy()[:, 1:] == 0.0)
    if case == "n = S - 1":   # one segment: the fused Pallas kernel
        a_k, s_k, n_k = kmeans_assign_reduce_pallas(
            jnp.asarray(x[0]), jnp.asarray(c[0]), jnp.asarray(w[0]),
            interpret=True)
        np.testing.assert_array_equal(a_e[0].numpy(), np.asarray(a_k))
        assert np.all(np.abs(s_e[0].numpy() - np.asarray(s_k))
                      <= 1e-5 * _cluster_abs(a_e[0].numpy(), x[0], w[0], K))
        np.testing.assert_allclose(n_e[0].numpy(), np.asarray(n_k),
                                   rtol=1e-5, atol=1e-6)


def test_segmented_emulation_order():
    """The emulation's order, spelled out on a small segment and fan-in (3
    rows a segment, groups of 2): each segment's cluster sums fold fmaf
    over its rows in row order from 0, and the tree adds ((s0 + s1) + (s2
    + s3)) + (s4 + 0) level by level from 0; the kernel's own assignment
    replaces the argmin when given."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, 14, 3)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((1, 2, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, (1, 14)).astype(np.float32))
    a = torch.from_numpy(rng.integers(0, 2, (1, 14)).astype(np.int32))
    got_a, got, cnt = tkm.kmeans_reduce_segmented_emulation(
        x, c, w, seg=3, fan_in=2, assign=a)
    assert torch.equal(got_a, a)
    f64 = np.float64
    parts = np.zeros((5, 2, 3), np.float32)      # 5 segments of 3 rows
    cparts = np.zeros((5, 2), np.float32)
    for i in range(14):
        k, s = int(a[0, i]), i // 3
        parts[s, k] = (f64(w[0, i]) * x[0, i].numpy().astype(f64)
                       + parts[s, k].astype(f64)).astype(np.float32)
        cparts[s, k] = np.float32(cparts[s, k] + w[0, i].numpy())
    for level in range(3):                       # 5 -> 3 -> 2 -> 1
        m = parts.shape[0]
        g = -(-m // 2)
        pad = np.zeros((g * 2 - m,) + parts.shape[1:], np.float32)
        cpad = np.zeros((g * 2 - m, 2), np.float32)
        pp = np.concatenate([parts, pad]).reshape(g, 2, 2, 3)
        cc = np.concatenate([cparts, cpad]).reshape(g, 2, 2)
        parts = (np.zeros_like(pp[:, 0]) + pp[:, 0]) + pp[:, 1]
        cparts = (np.zeros_like(cc[:, 0]) + cc[:, 0]) + cc[:, 1]
    assert parts.shape[0] == 1
    np.testing.assert_array_equal(got[0].numpy(), parts[0])
    np.testing.assert_array_equal(cnt[0].numpy(), cparts[0])


def test_reduce_plain_masks_padding_exactly():
    """Zero-weight rows add nothing; 0/1 counts are exact."""
    x = np.random.default_rng(0).normal(size=(37, 9)).astype(np.float32)
    w = (np.arange(37) < 30).astype(np.float32)
    a, sums, cnts = tkm.kmeans_assign_reduce_plain(
        torch.from_numpy(x), torch.from_numpy(x[:5]), torch.from_numpy(w))
    assert float(cnts.sum()) == 30.0
    manual = np.zeros((5, 9), np.float32)
    for i in range(30):
        manual[int(a[i])] += x[i]
    np.testing.assert_allclose(sums.numpy(), manual, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        cnts.numpy(), np.bincount(a.numpy()[:30], minlength=5))


def test_batched_problems_share_their_data_slab():
    """x (G, n, d) with cents (G·R, K, d): problem p reads slab p // R and
    gives the 2-D result of (x[p // R], cents[p])."""
    rng = np.random.default_rng(3)
    G, R, n, d, K = 2, 3, 50, 7, 4
    x = torch.from_numpy(rng.standard_normal((G, n, d)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((G * R, K, d)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(size=(G, n)) > 0.3).astype(np.float32))
    a, s, cnt = tkm.kmeans_assign_reduce_plain(x, c, w)
    assert a.shape == (G * R, n) and s.shape == (G * R, K, d)
    for p in range(G * R):
        a1, s1, n1 = tref.kmeans_assign_reduce_ref(x[p // R], c[p], w[p // R])
        np.testing.assert_array_equal(a[p].numpy(), a1.numpy())
        np.testing.assert_allclose(s[p].numpy(), s1.numpy(), atol=1e-6)
        np.testing.assert_array_equal(cnt[p].numpy(), n1.numpy())
        np.testing.assert_array_equal(
            tkm.kmeans_assign_plain(x, c)[p].numpy(), a1.numpy())


def test_cuda_wrappers_refuse_cpu_tensors_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", no_build)
    x, c, w = torch.zeros((4, 3)), torch.zeros((2, 3)), torch.ones(4)
    with pytest.raises(ValueError, match="CUDA"):
        tkm.kmeans_assign_cuda(x, c)
    with pytest.raises(ValueError, match="CUDA"):
        tkm.kmeans_assign_reduce_cuda(x, c, w)
    with pytest.raises(ValueError, match="CUDA"):
        ops.kmeans_assign(x, c, impl="cuda")
    before = dict(ops.launch_counts())
    ops.kmeans_assign(x, c)                   # CPU tensors: the plain version
    ops.kmeans_assign_reduce(x, c, w)
    assert ops.launch_counts() == before


def _bad_kmeans_args(case):
    x, c, w = torch.zeros((2, 8, 6)), torch.zeros((4, 3, 6)), torch.ones((2, 8))
    return {"d differs": (x, c[..., :5], w), "no centroids": (x, c[:, :0], w),
            "sets do not divide": (x, c[:3], w), "w shape": (x, c, w[:, :7]),
            "1-D x": (x[0, 0], c[0], w[0])}[case]


@pytest.mark.parametrize("case,reduce", [
    (c, r) for c in ("d differs", "no centroids", "sets do not divide",
                     "1-D x") for r in (False, True)] + [("w shape", True)])
def test_cuda_wrappers_refuse_bad_shapes_without_building(monkeypatch, case,
                                                          reduce):
    """Shapes the kernels do not take raise before anything is built or
    launched, on any device: the batch layout is checked first."""
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", no_build)
    x, c, w = _bad_kmeans_args(case)
    before = dict(ops.launch_counts())
    with pytest.raises(ValueError, match="must|divide|fit"):
        if reduce:
            tkm.kmeans_assign_reduce_cuda(x, c, w)
        else:
            tkm.kmeans_assign_cuda(x, c)
    assert ops.launch_counts() == before


# ------------------------------------------------------------------ Lloyd


@pytest.fixture(scope="module")
def fed_data():
    """A reference corpus and split at d_emb 32, 4 clients."""
    rcfg = JRouterConfig(d_emb=32, num_models=11)
    fcfg = JFedConfig(num_clients=4)
    corpus = jmake_eval_corpus(jax.random.PRNGKey(0), n_queries=4000,
                               d_emb=32)
    split = jfederated_split(jax.random.PRNGKey(1), corpus, fcfg)
    train = {k: np.array(v) for k, v in split["train"].items()}
    test = {k: np.array(v) for k, v in split["test_global"].items()}
    return rcfg, split, train, test


@pytest.fixture(scope="module")
def jax_fits(fed_data):
    """The reference's federated K-means router (``fed_kmeans_router``)
    fitted with 8 keys."""
    jr, split, _, _ = fed_data
    return [JKR.fed_kmeans_router(jax.random.PRNGKey(s), split["train"], jr)
            for s in range(8)]


@pytest.mark.parametrize("client,K,weighted", [(0, 15, False), (2, 20, True)])
def test_lloyd_from_the_reference_seeds(fed_data, client, K, weighted):
    _, _, train, _ = fed_data
    X = train["x"][client]
    w = train["w"][client]
    if weighted:
        w = w * np.random.default_rng(client).uniform(0.5, 2.0, w.shape).astype(
            np.float32)
    key = jax.random.PRNGKey(5 + client)
    seeds = JK._plusplus_init(key, jnp.asarray(X), jnp.asarray(w), K)
    c_ref, inertia_ref = JK._lloyd_once(key, jnp.asarray(X), jnp.asarray(w),
                                        K, 30)
    c, inertia, assign = TK.lloyd(torch.from_numpy(X)[None],
                                  torch.from_numpy(w)[None],
                                  torch.from_numpy(np.array(seeds))[None, None],
                                  30)
    np.testing.assert_allclose(c[0, 0].numpy(), np.asarray(c_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(inertia[0, 0]), float(inertia_ref),
                               rtol=1e-5)
    _assert_assign(assign[0, 0].numpy(),
                   np.asarray(jref.kmeans_assign_ref(jnp.asarray(X), c_ref)),
                   X, np.asarray(c_ref))


def test_plusplus_seeds_are_weighted_data_points():
    """Seeds are distinct rows of X and never a zero-weight row."""
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.standard_normal((2, 60, 5)).astype(np.float32))
    w = torch.ones((2, 60))
    w[:, 40:] = 0.0
    seeds = TK._plusplus_init(torch.Generator().manual_seed(0), X, w, 8, 3)
    assert seeds.shape == (2, 3, 8, 5)
    for g in range(2):
        for r in range(3):
            hit = (seeds[g, r][:, None] == X[g][None]).all(-1)   # (8, 60)
            rows = hit.float().argmax(-1)
            assert hit.any(-1).all() and (rows < 40).all()
            assert len(set(rows.tolist())) == 8


# ------------------------------------------------------- cluster statistics


def _tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_statistics_from_the_reference_centroids(fed_data, jax_fits):
    jr, split, train, test = fed_data
    M, K = jr.num_models, jr.k_global
    cents = jax_fits[0]["centroids"]
    rcfg = RouterConfig(d_emb=32, num_models=M)
    ct = torch.from_numpy(np.array(cents))
    data = _tree(split["train"])

    a_j, c_j, n_j = jax.vmap(lambda di: JKR._cluster_stats(cents, di, K, M))(
        split["train"])
    a_t, c_t, n_t = TKR._cluster_stats(ct, data, K, M)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6,
                               atol=1e-6)

    A_j, C_j = JKR._finalize(*(jnp.sum(t, 0) for t in (a_j, c_j, n_j)), 1.0)
    A_t, C_t = TKR._finalize(a_t.sum(0), c_t.sum(0), n_t.sum(0), 1.0)
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), rtol=1e-6,
                               atol=1e-6)

    jstate = {"centroids": cents, "A": A_j, "C": C_j,
              "n": jnp.sum(n_j, 0)}
    tstate = {"centroids": ct, "A": A_t, "C": C_t, "n": n_t.sum(0)}
    pa_j, pc_j = JKR.predict(jstate, jnp.asarray(test["x"]))
    pa_t, pc_t = TKR.predict(tstate, torch.from_numpy(test["x"]))
    np.testing.assert_allclose(pa_t.numpy(), np.asarray(pa_j), atol=1e-6)
    np.testing.assert_allclose(pc_t.numpy(), np.asarray(pc_j), atol=1e-6)

    # onboarding a model from calibration evals; merging a new client
    rng = np.random.default_rng(9)
    calib = {"x": test["x"][:300],
             "acc": (rng.uniform(size=300) > 0.4).astype(np.float32),
             "cost": rng.uniform(size=300).astype(np.float32),
             "w": np.ones(300, np.float32)}
    on_j = JKR.add_model_stats(jstate, {k: jnp.asarray(v)
                                        for k, v in calib.items()})
    on_t = TKR.add_model_stats(tstate, _tree(calib))
    new = {k: v[:1] for k, v in split["train"].items()}
    mg_j = JKR.merge_client_stats(jstate, new, jr)
    mg_t = TKR.merge_client_stats(tstate, _tree(new), rcfg)
    for got, want in ((on_t, on_j), (mg_t, mg_j)):
        np.testing.assert_array_equal(got["n"].numpy(), np.asarray(want["n"]))
        for k in ("A", "C"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lam", [0.0, 0.5, 3.0])
def test_kmeans_route_matches_the_reference(fed_data, jax_fits, lam):
    jr, split, train, test = fed_data
    jrouter = jrouters.make("kmeans", jr, state=jax_fits[1])
    state = convert.router_state_from_numpy(
        jax.tree.map(np.asarray, jrouter.state), device="cpu")
    trouter = routers.make("kmeans", RouterConfig(d_emb=32), state=state)
    x = test["x"][:257]
    got = trouter.route(torch.from_numpy(x), lam)
    assert got.dtype == torch.int32
    want = np.asarray(jrouter.route(jnp.asarray(x), lam))
    U = np.asarray(jrouter.state["A"] - lam * jrouter.state["C"])
    top2 = np.sort(U, axis=1)[:, -2:]
    cluster_tie = (top2[:, 1] - top2[:, 0]) < 1e-6
    k = np.asarray(jref.kmeans_assign_ref(jnp.asarray(x),
                                          jrouter.state["centroids"]))
    ok = (got.numpy() == want) | cluster_tie[k] | _near_ties(
        x, np.asarray(jrouter.state["centroids"]))
    assert ok.all()


# ------------------------------------------------------------- end to end


def test_fed_kmeans_auc_matches_the_reference(fed_data, jax_fits):
    jr, split, train, test = fed_data
    rcfg = RouterConfig(d_emb=32, num_models=11)
    j_auc = [JP.eval_router(lambda x, st=st: JKR.predict(st, x), test["x"],
                            test["acc_table"], test["cost_table"])[2]
             for st in jax_fits]
    tt = {k: torch.from_numpy(v) for k, v in test.items()}
    t_auc = []
    for s in range(len(jax_fits)):
        r, _ = routers.fit_federated(routers.make("kmeans", rcfg), train,
                                     FedConfig(num_clients=4), gen=s,
                                     device="cpu")
        t_auc.append(TP.eval_router(r.predict, tt["x"], tt["acc_table"],
                                    tt["cost_table"])[2])
    assert abs(np.mean(t_auc) - np.mean(j_auc)) <= 0.02, (t_auc, j_auc)
