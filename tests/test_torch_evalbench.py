"""The port's RouterBench harness (``repro_torch.evalbench``) on the CPU,
against the JAX package.

Inputs come from the reference: its pool corpus and federated split
(``jax.random`` keys), its fitted K-means router and its MLP and MF router
inits (carried across through ``repro_torch.convert``), and its paraphrase
noise. Held to:

  * ``pool_table`` equal (same float64 sums); ``reference_points`` and
    ``sweep`` to 1e-6 (f32 means in another order), including the split
    where the oracle's frontier area lies below the best single model's
    accuracy (the reason ``tests/test_evalbench.py::
    test_reference_points_scale_and_ordering`` fails in the reference);
  * ``paraphrase_drift`` equal with the reference's noise injected;
  * ``adversarial_queries`` — donors, ``x_adv``, ``flip_rate`` and
    ``mean_rel_norm`` equal to the reference's at its test's sizes (64 and
    500 rows); the blocked float64 donor search equal to the reference's
    dense (Q, Q, d) formula; first index on equidistant donors; no donor
    when every query takes one route;
  * ``offline_routerbench`` — the reference test's contract, a repeated
    call returning an equal dict; with the reference's split and noise
    injected, K-means and Elo at one centroid (their fits then draw
    nothing that changes the state) to 1e-6, and Elo, MLP and MF at the
    reference test's router config within ``ONE_SHOT_BAND`` (Elo: only the
    k-means++ seeds differ; K-means measured within 0.0032 too) or
    ``PARAMETRIC_BAND`` (MLP and MF: the reference's init of every fit
    injected, so only the minibatch draws differ; the reference's own
    AIQs move by up to 0.060 (MLP) and 0.038 (MF) between four other
    minibatch keys from the same inits, and the port's lie within 0.011
    of the reference's for both. Without the injected inits the gap is
    0.15 to 0.21: 2 rounds and 5 local steps leave each AIQ mostly a
    function of the init draw);
  * ``online_routerbench`` — with the reference's corpus, pool and MF init
    injected, the accounting equal, the phase-0 online AUC to 1e-6 and
    every AUC within 0.1 (as ``run_online_vs_frozen`` is held).
"""
import zlib

import jax
import numpy as np
import pytest
import torch

from repro import routers as jrouters
from repro.config import FedConfig as JFedConfig
from repro.config import RouterConfig as JRouterConfig
from repro.data.partition import federated_split as jfederated_split
from repro.data.synthetic import make_eval_corpus as jmake_eval_corpus
from repro.evalbench import harness as jh
from repro.evalbench import metrics as jm
from repro.evalbench import perturb as jp
from repro.evalbench.pools import make_pool_corpus as jmake_pool_corpus
from repro.evalbench.pools import pool_table as jpool_table
from repro.fed import scenarios as jscen
from repro.models import init_params as jinit_params
from repro_torch import convert
from repro_torch import routers
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.evalbench import harness as th
from repro_torch.evalbench import metrics as tm
from repro_torch.evalbench import perturb as tp
from repro_torch.evalbench.pools import make_pool_corpus, pool_table
from repro_torch.fed import scenarios as tscen
from repro_torch.routers.mf import MFRouter

torch.set_num_threads(1)

RC = dict(d_emb=12, num_models=4, hidden=(16, 16), dropout=0.0, k_local=3,
          k_global=4, mf_rank=6)
FC = dict(num_clients=3, rounds=2, batch_size=32, lr=3e-3, seed=0)
RCFG, FCFG = RouterConfig(**RC), FedConfig(**FC)
TOL = 1e-6
ONE_SHOT_BAND = 0.01
PARAMETRIC_BAND = 0.04
AUC_BAND = 0.1


def _t(tree):
    """A reference tree (dicts, lists, arrays) as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_t(v) for v in tree]
    if hasattr(tree, "shape"):
        return torch.as_tensor(np.array(tree))
    return tree


@pytest.fixture(scope="module")
def jcorpus():
    return jmake_pool_corpus(jax.random.PRNGKey(0), n_models=4,
                             n_queries=500, n_tasks=3, d_emb=12)


@pytest.fixture(scope="module")
def jsplit(jcorpus):
    return jfederated_split(jax.random.PRNGKey(1), jcorpus, JFedConfig(**FC))


@pytest.fixture(scope="module")
def test_pair(jsplit):
    return jsplit["test_global"], _t(jsplit["test_global"])


@pytest.fixture(scope="module")
def kmeans_pair(jsplit):
    """The reference test's fitted K-means router and its port twin."""
    j, _ = jrouters.fit_federated(jrouters.make("kmeans", JRouterConfig(**RC)),
                                  jsplit["train"], JFedConfig(**FC),
                                  key=jax.random.PRNGKey(2))
    state = convert.router_state_from_numpy(
        jax.tree.map(np.asarray, j.state), device="cpu")
    return j, routers.make("kmeans", RCFG, state=state)


@pytest.fixture(scope="module")
def mlp_pair():
    """An MLP router at its reference init, in both packages."""
    j = jrouters.make("mlp", JRouterConfig(**RC)).init(jax.random.PRNGKey(4))
    state = convert.router_state_from_numpy(
        jax.tree.map(np.asarray, j.state), device="cpu")
    return j, routers.make("mlp", RCFG, state=state)


# ------------------------------------------------------------------ metrics


def test_pool_table_equal_to_reference(jcorpus):
    got = pool_table(_t(jcorpus))
    assert got == jpool_table(jcorpus)
    assert sum(r["wins"] for r in got) == 500


def test_make_pool_corpus_on_the_cpu():
    c = make_pool_corpus(3, n_models=5, n_queries=64, n_tasks=2, d_emb=8,
                         device="cpu")
    assert c["acc_table"].shape == (64, 5) and c["n_models"] == 5
    again = make_pool_corpus(3, n_models=5, n_queries=64, n_tasks=2,
                             d_emb=8, device="cpu")
    assert torch.equal(c["x"], again["x"])
    assert len(pool_table(c)) == 5


def test_reference_points_equal_to_reference(test_pair):
    jt, tt = test_pair
    want, got = jm.reference_points(jt), tm.reference_points(tt)
    assert got["models"] == want["models"]
    for k in ("zero_router_aiq", "best_single_aiq", "random_aiq",
              "oracle_aiq"):
        assert abs(got[k] - want[k]) <= TOL, k
    # the reference's own ordering failure, reproduced: a λ-swept
    # frontier area against one model's accuracy
    assert got["oracle_aiq"] < got["best_single_aiq"]
    assert want["oracle_aiq"] < want["best_single_aiq"]


@pytest.mark.parametrize("fam", ["kmeans", "mlp"])
def test_sweep_equal_for_an_injected_router(test_pair, kmeans_pair,
                                            mlp_pair, fam):
    jt, tt = test_pair
    j, t = kmeans_pair if fam == "kmeans" else mlp_pair
    want, got = jm.sweep(j.predict, jt), tm.sweep(t.predict, tt)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got["accs"], want["accs"], rtol=0, atol=TOL)
    assert abs(got["aiq"] - want["aiq"]) <= TOL
    assert 0.0 <= got["aiq"] <= tm.reference_points(tt)["oracle_aiq"] + 0.2


def test_aiq_of_single_point_is_its_accuracy():
    assert tm.aiq(np.array([0.4]), np.array([0.8])) == pytest.approx(0.8)


# ---------------------------------------------------------------- scenarios


def test_paraphrase_drift_equal_with_injected_noise(test_pair):
    jt, tt = test_pair
    x = jt["x"][:32]
    noise = jax.random.normal(jax.random.PRNGKey(3), x.shape)
    want = jp.paraphrase_drift(jax.random.PRNGKey(3), x, 0.25)
    got = tp.paraphrase_drift(_t(noise), tt["x"][:32], 0.25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="noise of shape"):
        tp.paraphrase_drift(_t(noise)[:3], tt["x"][:32], 0.25)


def test_paraphrase_drift_is_seeded_and_scaled(test_pair):
    x = test_pair[1]["x"][:32]
    a, b = (tp.paraphrase_drift(3, x, 0.25) for _ in range(2))
    assert torch.equal(a, b)
    c = tp.paraphrase_drift(torch.Generator().manual_seed(4), x, 0.25)
    assert float((a - c).abs().max()) > 0
    assert torch.equal(tp.paraphrase_drift(3, x, 0.0), x)


def _ref_donors(x, m):
    """The reference's dense (Q, Q, d) donor search (perturb.py:48-52)."""
    x = np.asarray(x, np.float64)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    d2 = np.where(m[:, None] == m[None, :], np.inf, d2)
    donor = d2.argmin(axis=1)
    return donor, np.isfinite(d2[np.arange(len(x)), donor])


@pytest.mark.parametrize("fam", ["kmeans", "mlp"])
@pytest.mark.parametrize("n", [64, 500])
def test_adversarial_queries_equal_to_reference(jsplit, kmeans_pair,
                                                mlp_pair, fam, n):
    j, t = kmeans_pair if fam == "kmeans" else mlp_pair
    x = np.array(jsplit["test_global"]["x"])[:n]
    lam = 0.5
    m0 = np.asarray(j.route(x, lam))
    assert np.array_equal(t.route(torch.as_tensor(x), lam).numpy(), m0)
    want_d, want_has = _ref_donors(x, m0)
    got_d, got_has = tp.nearest_donor(torch.as_tensor(x),
                                      torch.as_tensor(m0))
    np.testing.assert_array_equal(got_d.numpy()[want_has], want_d[want_has])
    np.testing.assert_array_equal(got_has.numpy(), want_has)

    want_x, want_info = jp.adversarial_queries(j, x, lam, budget=0.35)
    got_x, got_info = tp.adversarial_queries(t, torch.as_tensor(x), lam,
                                             budget=0.35)
    assert got_x.dtype == torch.float32 and got_x.shape == x.shape
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    assert got_info["flip_rate"] == want_info["flip_rate"]
    assert abs(got_info["mean_rel_norm"] - want_info["mean_rel_norm"]) <= 1e-12
    assert got_info["flip_rate"] > 0 or fam == "kmeans"
    # the reference test's budget discipline, on the port's result
    changed = np.any(got_x.numpy() != x, axis=1)
    m1 = t.route(got_x, lam).numpy()
    assert np.all(m0[changed] != m1[changed])
    rel = (np.linalg.norm(got_x.numpy() - x, axis=1)
           / np.maximum(np.linalg.norm(x, axis=1), 1e-12))
    assert np.all(rel[changed] <= 0.35 + 1e-6)
    again = tp.adversarial_queries(t, torch.as_tensor(x), lam, budget=0.35)
    assert torch.equal(again[0], got_x) and again[1] == got_info


@pytest.mark.parametrize("block", [1, 7, 64, 4096])
def test_blocked_donor_search_equals_the_dense_formula(block):
    rng = np.random.default_rng(block)
    x = rng.standard_normal((150, 9)).astype(np.float32)
    m = rng.integers(0, 3, size=150)
    want_d, want_has = _ref_donors(x, m)
    got_d, got_has = tp.nearest_donor(torch.as_tensor(x),
                                      torch.as_tensor(m), block=block)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    assert got_has.all() and want_has.all()


def test_donor_ties_take_the_first_index_and_one_route_has_none():
    # row 0 at the origin; rows 1 and 2 equidistant and routed elsewhere
    x = torch.tensor([[0.0, 0.0], [0.0, 2.0], [2.0, 0.0], [0.0, -2.0]])
    m = torch.tensor([0, 1, 1, 1])
    want_d, _ = _ref_donors(x.numpy(), m.numpy())
    donor, has = tp.nearest_donor(x, m)
    assert int(donor[0]) == int(want_d[0]) == 1
    assert has.tolist() == [True] * 4
    donor, has = tp.nearest_donor(x, torch.zeros(4, dtype=torch.int64))
    assert not has.any()


def test_single_route_router_flips_nothing(test_pair, kmeans_pair):
    """A router whose every query takes one model: no donor anywhere, the
    attack returns x unchanged (as the reference does)."""
    _, t = kmeans_pair
    state = dict(t.state)
    state["A"] = torch.zeros_like(state["A"])
    state["C"] = torch.zeros_like(state["C"])
    one = routers.make("kmeans", RCFG, state=state)
    x = test_pair[1]["x"][:40]
    x_adv, info = tp.adversarial_queries(one, x, 0.5)
    assert torch.equal(x_adv, x)
    assert info == {"flip_rate": 0.0, "mean_rel_norm": 0.0}


def test_eval_scenarios_shape(test_pair, kmeans_pair):
    res = th.eval_scenarios(kmeans_pair[1], test_pair[1], 5)
    assert set(res) == set(th.SCENARIOS)
    for sc in th.SCENARIOS:
        assert 0.0 <= res[sc]["aiq"] <= 1.0
    assert "flip_rate" in res["adversarial"]


# ------------------------------------------------------------------ harness


def test_offline_routerbench_contract(jcorpus):
    """The reference test's contract, and a repeated call equal."""
    kw = dict(rcfg=RCFG, fcfg=FCFG, families=("kmeans", "elo"),
              corpus=_t(jcorpus), local_steps=5, device="cpu")
    res = th.offline_routerbench(7, **kw)
    assert res["n_models"] == 4 and res["n_clients"] == 3
    assert set(res["families"]) == {"kmeans", "elo"}
    for fam in res["families"].values():
        assert fam["clients_fit"] >= 1
        for side in ("federated", "client_local"):
            assert set(fam[side]) == set(th.SCENARIOS)
            for sc in th.SCENARIOS:
                assert 0.0 <= fam[side][sc]["aiq"] <= 1.0
    assert th.offline_routerbench(7, **kw) == res
    assert th.offline_routerbench(torch.Generator().manual_seed(7),
                                  **kw) == res


def test_offline_routerbench_skips_a_starved_client(jcorpus, monkeypatch):
    split = jfederated_split(jax.random.PRNGKey(1), jcorpus,
                             JFedConfig(**FC))
    train = dict(split["train"])
    train["w"] = np.asarray(train["w"]).copy()
    train["w"][1] = 0.0
    monkeypatch.setattr(th, "federated_split",
                        lambda g, c, f: _t({**split, "train": train}))
    res = th.offline_routerbench(7, rcfg=RCFG, fcfg=FCFG,
                                 families=("kmeans",), corpus=_t(jcorpus),
                                 device="cpu")
    assert res["families"]["kmeans"]["clients_fit"] == 2


def _inject_offline(monkeypatch, jcorpus, seed):
    """The reference's split and paraphrase noise for key ``seed``."""
    _, k_split, k_pert, _ = jax.random.split(jax.random.PRNGKey(seed), 4)
    split = jfederated_split(k_split, jcorpus, JFedConfig(**FC))
    monkeypatch.setattr(th, "federated_split", lambda g, c, f: _t(split))
    noise = torch.as_tensor(np.asarray(jax.random.normal(
        k_pert, split["test_global"]["x"].shape)))
    monkeypatch.setattr(th, "paraphrase_drift",
                        lambda g, x, s: tp.paraphrase_drift(noise, x, s))


def _inject_inits(monkeypatch, seed, fams):
    """The reference's init of every federated and client-local fit of
    ``fams`` (``offline_routerbench`` on key ``seed``): the federated fit
    inits from split(k_fed)[1], client c's from split(fold_in(k_loc,
    c))[1]. Clients are fitted in order and none is starved here."""
    _, _, _, k_fit = jax.random.split(jax.random.PRNGKey(seed), 4)
    keys = {f: jax.random.split(jax.random.fold_in(
        k_fit, zlib.crc32(f.encode()) % (2 ** 31))) for f in fams}

    def init(router, which, c=None):
        if router.name not in keys:
            return router
        key = keys[router.name][which]
        key = key if c is None else jax.random.fold_in(key, c)
        j = jrouters.make(router.name, JRouterConfig(**RC)).init(
            jax.random.split(key)[1])
        return router.with_state(convert.router_state_from_numpy(
            jax.tree.map(np.asarray, j.state), device="cpu"))

    fed0, loc0 = routers.fit_federated, routers.fit_local
    clients = {}

    def fed(router, data, fcfg, **kw):
        clients[router.name] = 0
        return fed0(init(router, 0), data, fcfg, **kw)

    def loc(router, data, fcfg, **kw):
        c = clients[router.name]
        clients[router.name] += 1
        return loc0(init(router, 1, c), data, fcfg, **kw)

    monkeypatch.setattr(routers, "fit_federated", fed)
    monkeypatch.setattr(routers, "fit_local", loc)


def _gaps(got, want, fams):
    out = {}
    for f in fams:
        a, b = got["families"][f], want["families"][f]
        assert a["clients_fit"] == b["clients_fit"]
        out[f] = max(abs(a[side][sc]["aiq"] - b[side][sc]["aiq"])
                     for side in ("federated", "client_local")
                     for sc in th.SCENARIOS)
    return out


def test_offline_routerbench_draw_free_families_equal(jcorpus, monkeypatch):
    """K-means and Elo at one centroid: every k-means++ seed converges to
    the weighted mean, so their fits are functions of the data alone."""
    rc = {**RC, "k_local": 1, "k_global": 1}
    fams = ("kmeans", "elo")
    want = jh.offline_routerbench(jax.random.PRNGKey(7),
                                  rcfg=JRouterConfig(**rc),
                                  fcfg=JFedConfig(**FC), families=fams,
                                  corpus=jcorpus, local_steps=5)
    _inject_offline(monkeypatch, jcorpus, 7)
    got = th.offline_routerbench(7, rcfg=RouterConfig(**rc), fcfg=FCFG,
                                 families=fams, corpus=_t(jcorpus),
                                 local_steps=5, device="cpu")
    assert got["pool"] == want["pool"]
    for k, v in want["reference"].items():
        if k != "models":
            assert abs(got["reference"][k] - v) <= TOL, k
    assert max(_gaps(got, want, fams).values()) <= TOL
    for f in fams:
        a = got["families"][f]["federated"]["adversarial"]
        b = want["families"][f]["federated"]["adversarial"]
        assert a["flip_rate"] == b["flip_rate"]
        assert abs(a["mean_rel_norm"] - b["mean_rel_norm"]) <= TOL


def test_offline_routerbench_within_band_of_reference(jcorpus, monkeypatch):
    fams = ("elo", "mlp", "mf")
    want = jh.offline_routerbench(jax.random.PRNGKey(7),
                                  rcfg=JRouterConfig(**RC),
                                  fcfg=JFedConfig(**FC), families=fams,
                                  corpus=jcorpus, local_steps=5)
    _inject_offline(monkeypatch, jcorpus, 7)
    _inject_inits(monkeypatch, 7, ("mlp", "mf"))
    got = th.offline_routerbench(7, rcfg=RCFG, fcfg=FCFG, families=fams,
                                 corpus=_t(jcorpus), local_steps=5,
                                 device="cpu")
    gaps = _gaps(got, want, fams)
    assert gaps["elo"] <= ONE_SHOT_BAND, gaps
    assert gaps["mlp"] <= PARAMETRIC_BAND, gaps
    assert gaps["mf"] <= PARAMETRIC_BAND, gaps


def test_online_routerbench_matches_reference(monkeypatch):
    kw = dict(n_clients=4, n_tasks=4, n_models=2, d_emb=16, n_queries=400,
              queries_per_phase=24, phases=2, test_queries=24, seed=0,
              embed_sigma=0.5)
    run = dict(local_steps=60, capacity=64)
    want = jh.online_routerbench(family="mf", cfg=jscen.ScenarioConfig(**kw),
                                 **run)
    monkeypatch.setattr(tscen, "make_eval_corpus",
                        lambda gen, **k: jmake_eval_corpus(
                            jax.random.PRNGKey(gen.initial_seed()), **k))
    jparams = jinit_params(jax.random.PRNGKey(1), jscen.SIM_MODEL)
    monkeypatch.setattr(
        tscen, "init_params",
        lambda gen, cfg, device=None: convert.model_params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, device=device))
    rcfg = JRouterConfig(d_emb=16, num_models=2, hidden=(32, 32),
                         dropout=0.0)
    state = jax.tree.map(np.asarray, jrouters.make("mf", rcfg).init(
        jax.random.PRNGKey(11)).state)
    monkeypatch.setattr(
        MFRouter, "init", lambda self, gen, device=None: self.with_state(
            convert.router_state_from_numpy(state, device=device)))
    got = th.online_routerbench(family="mf",
                                cfg=tscen.ScenarioConfig(**kw),
                                device="cpu", **run)
    assert got["family"] == "mf" and got["embed_sigma"] == 0.5
    for k in ("requests_served", "harvested_samples", "harvest_bytes",
              "num_models_final", "syncs", "router_version"):
        assert got[k] == want[k], k
    assert abs(got["auc_online"][0] - want["auc_online"][0]) <= TOL
    for k in ("auc_online", "auc_frozen_local"):
        for a, b in zip(got[k], want[k]):
            assert abs(a - b) <= AUC_BAND, (k, got[k], want[k])
