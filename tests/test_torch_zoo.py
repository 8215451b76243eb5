"""The paper's remaining router features in the port, against the JAX
reference on the CPU: the MF and Elo families, §6.3 model and App. D.3
client onboarding, the fit's ``freeze`` / ``distill`` / ``client_mask`` /
``loss_fn``, the K-means ``client_mask``, §6.4 personalization and secure
aggregation.

Inputs are the reference's own corpus and split (d_emb 24, 5 models, 4
clients) or numpy draws from a seed, fed to both sides; reference params
come into the port through ``repro_torch.convert``. Deterministic fits use
``full_batch=True``, ``participation=1.0`` and no dropout.

Tolerances, stated per check:
  * MF forward and loss: 1e-6 (a few f32 products in another order);
  * deterministic FedAvg with a knob (MF loss, freeze, distill with and
    without ``apply_fn``, client_mask), 3 rounds: under SGD params leaf by
    leaf to |Δ| ≤ 1e-5·|ref| + 1e-5·max|ref| and the per-round loss to
    1e-5 relative; under AdamW the fitted router's predictions on 300 test
    queries to 1e-4 and the loss to 1e-4 relative — Adam divides by √v, so
    a parameter whose gradient is near 0 (a trunk bias component that the
    LayerNorm after it hides) moves by amounts set by f32 rounding, which
    the function does not see;
  * frozen leaves after onboarding: bit-identical; after a frozen FedAvg
    fit within 1e-6 relative (the server's weighted sum rounds them);
  * ``route``: equal to argmax A − λC except on rows whose top-2 utility
    margin is below 1e-5 (the kernel path rounds the heads otherwise);
  * Elo statistics, ratings and predictions from the same anchors:
    |Δ| ≤ 1e-5·|ref| + 1e-5·max(1, max|ref of the leaf|) (f32 sums over a
    client's rows in another order, through a softmax at the default
    bandwidth; ratings are 174·logit(p), so their scale is the leaf's);
  * stochastic one-shot fits (federated Elo, the masked K-means fit): the
    mean frontier AUC over 8 seeds within 0.02 of the reference's mean
    over 8 keys (one fit's AUC spreads by ~0.02 across seeds);
  * onboarding from the reference's fitted state (minibatch draws differ):
    per seed, frontier AUC within 0.02 of the reference's (measured
    ≤ 0.013) and, for model onboarding, the calibration loss within 3%
    (measured ≤ 1%);
  * personalization: 1e-6, the ±∞ edges exactly;
  * secure aggregation: scale 0 bit-identical to FedAvg (one aggregation
    and a whole stochastic fit); scale 10 within 1e-6·scale·N per
    parameter for one aggregation of N clients and after one round (each
    upload carries masks of ~scale·√N/w̃_i, rounded in f32 and weighted
    back by w̃_i); the classic mask → sum round trip to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import routers as jrouters
from repro.config import FedConfig as JFedConfig
from repro.config import RouterConfig as JRouterConfig
from repro.core import elo_router as JEL
from repro.core import expansion as JE
from repro.core import federated as JF
from repro.core import kmeans_router as JKR
from repro.core import mf_router as JMF
from repro.core import mlp_router as JR
from repro.core import personalization as JPZ
from repro.core import policy as JP
from repro.core import secure_agg as JSA
from repro.data.partition import federated_split as jfederated_split
from repro.data.synthetic import make_eval_corpus as jmake_eval_corpus
from repro_torch import convert, routers
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.core import elo_router as TEL
from repro_torch.core import expansion as TE
from repro_torch.core import federated as TF
from repro_torch.core import mf_router as TMF
from repro_torch.core import mlp_router as TR
from repro_torch.core import personalization as TPZ
from repro_torch.core import policy as TP
from repro_torch.core import secure_agg as TSA
from repro_torch.fed import aggregators as tagg
from repro_torch.train.optim import tree_leaves

torch.set_num_threads(1)

M = 5
RK = dict(d_emb=24, num_models=M, hidden=(32, 32), mf_rank=8, k_local=6,
          k_global=6, dropout=0.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return convert.router_state_from_numpy(_np(tree), device="cpu")


def _tt(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _close(got, want, rtol):
    """Leaf by leaf |Δ| ≤ rtol·|ref| + rtol·max|ref of the leaf|."""
    def one(w, g):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()))
    jax.tree.map(one, _np(want), convert.state_to_numpy(got))


def _configs(**fed):
    fk = dict(num_clients=4, **fed)
    return (JRouterConfig(**RK), JFedConfig(**fk), RouterConfig(**RK),
            FedConfig(**fk))


@pytest.fixture(scope="module")
def fed_data():
    """The reference's corpus and split, as numpy."""
    corpus = jmake_eval_corpus(jax.random.PRNGKey(0), n_queries=1600,
                               n_tasks=4, n_models=M, d_emb=RK["d_emb"])
    split = jfederated_split(jax.random.PRNGKey(1), corpus,
                             JFedConfig(num_clients=4))
    train = {k: np.array(v) for k, v in split["train"].items()}
    test = {k: np.array(v) for k, v in split["test_global"].items()}
    return split, train, test


def _auc_t(predict, test):
    return TP.eval_router(predict, *(torch.from_numpy(test[k]) for k in
                                     ("x", "acc_table", "cost_table")))[2]


def _auc_j(predict, test):
    return JP.eval_router(predict, jnp.asarray(test["x"]), test["acc_table"],
                          test["cost_table"])[2]


def _batch(rng, B, d, weighted=True):
    b = {"x": rng.standard_normal((B, d)).astype(np.float32),
         "m": rng.integers(0, M, B).astype(np.int32),
         "acc": (rng.uniform(size=B) > 0.5).astype(np.float32),
         "cost": rng.uniform(size=B).astype(np.float32)}
    if weighted:
        b["w"] = (np.arange(B) < B - 5).astype(np.float32)
    return b


def _near_tie_ok(got, want, U, margin=1e-5):
    top2 = np.sort(U, axis=1)[:, -2:]
    return (got == want) | ((top2[:, 1] - top2[:, 0]) < margin)


# ------------------------------------------------------------------- MF


@pytest.mark.parametrize("weighted", [True, False])
def test_mf_forward_and_loss_match_reference(weighted):
    jr, _, tr, _ = _configs()
    params = JMF.init_mf_router(jax.random.PRNGKey(0), jr)
    b = _batch(np.random.default_rng(1), 41, RK["d_emb"], weighted)
    jA, jC = JMF.apply_mf_router(params, jnp.asarray(b["x"]))
    tA, tC = TMF.apply_mf_router(_t(params), torch.from_numpy(b["x"]))
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tC.numpy(), np.asarray(jC), rtol=1e-6,
                               atol=1e-6)
    want = JMF.mf_loss(params, jax.tree.map(jnp.asarray, b), jr)
    got = TMF.mf_loss(_t(params), _tt(b), tr)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    # stacked params (2 clients) give each client's own loss
    st = jax.tree.map(lambda a: torch.stack([a, 2 * a]), _t(params))
    sb = {k: torch.stack([v, v]) for k, v in _tt(b).items()}
    two = TMF.mf_loss(st, sb, tr)
    half = jax.tree.map(lambda a: 2 * a, params)
    np.testing.assert_allclose(
        two.numpy(), [float(want), float(JMF.mf_loss(
            half, jax.tree.map(jnp.asarray, b), jr))], rtol=1e-6, atol=1e-6)


def _deterministic_fit(fed_data, knob, optimizer, rounds=3):
    """The reference's and the port's deterministic FedAvg with one knob
    set, from the same init. Returns (jax params, jax loss, port params,
    port loss, the port's init)."""
    split, train, _ = fed_data
    jr, jf, tr, tf = _configs(participation=1.0,
                              lr=3e-3 if optimizer == "adamw" else 0.3)
    mf = knob in ("mf_loss", "distill_apply_fn")
    jinit = (JMF.init_mf_router if mf else JR.init_mlp_router)(
        jax.random.PRNGKey(6), jr)
    tinit = _t(jinit)
    jkw, tkw = {}, {}
    if mf:
        jkw["loss_fn"], tkw["loss_fn"] = JMF.mf_loss, TMF.mf_loss
    if knob == "freeze":
        grown = JE.add_models(jinit, jax.random.PRNGKey(3), 2)
        jinit, tinit = grown, _t(grown)
        jkw["freeze"] = JE.new_head_freeze_mask(grown, 2)
        tkw["freeze"] = TE.new_head_freeze_mask(tinit, 2)
    elif knob == "distill":
        theta0 = JR.init_mlp_router(jax.random.PRNGKey(8), jr)
        jkw["distill"], tkw["distill"] = (theta0, 0.7), (_t(theta0), 0.7)
    elif knob == "distill_apply_fn":
        theta0 = JMF.init_mf_router(jax.random.PRNGKey(8), jr)
        jkw["distill"] = (theta0, 0.7, JMF.apply_mf_router)
        tkw["distill"] = (_t(theta0), 0.7, TMF.apply_mf_router)
    elif knob == "client_mask":
        mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
        jkw["client_mask"], tkw["client_mask"] = jnp.asarray(mask), mask
    jp, jh = JF.fedavg(jax.random.PRNGKey(7), split["train"], jr, jf,
                       rounds=rounds, init=jinit, full_batch=True,
                       optimizer=optimizer, **jkw)
    tp, th = TF.fedavg(torch.Generator().manual_seed(7), _tt(train), tr, tf,
                       rounds=rounds, init=tinit, full_batch=True,
                       optimizer=optimizer, **tkw)
    return jp, jh["loss"], tp, th["loss"], tinit


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
@pytest.mark.parametrize("knob", ["mf_loss", "freeze", "distill",
                                  "distill_apply_fn", "client_mask"])
def test_deterministic_fedavg_knob_matches_reference(fed_data, knob,
                                                     optimizer):
    jp, jl, tp, tl, tinit = _deterministic_fit(fed_data, knob, optimizer)
    if optimizer == "sgd":
        _close(tp, jp, rtol=1e-5)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    else:
        x = fed_data[2]["x"][:300]
        mf = knob in ("mf_loss", "distill_apply_fn")
        japply = JMF.apply_mf_router if mf else JR.apply_mlp_router
        tapply = TMF.apply_mf_router if mf else TR.apply_mlp_router
        for got, want in zip(tapply(tp, torch.from_numpy(x)),
                             japply(jp, jnp.asarray(x))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-4)
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
    if knob == "freeze":
        # only the 2 new head columns train; the frozen entries move by the
        # server's weighted sum alone (Σ w̃_i·p with Σ w̃_i = 1 up to f32
        # rounding), as in the reference
        def same(a, b):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=0)
        # the data logs none of the 2 new models, so under AdamW only the
        # weight decay moves their columns, and under SGD nothing does
        for key in ("acc_w", "cost_w", "acc_b", "cost_b"):
            same(tp["heads"][key][..., :-2], tinit["heads"][key][..., :-2])
        for a, b in zip(tree_leaves(tp["trunk"]), tree_leaves(tinit["trunk"])):
            same(a, b)


def test_client_mask_trains_only_eligible_clients(fed_data):
    """With participation 0.5 the drawn clients are restricted to the mask;
    a round whose draw misses the mask trains the whole eligible pool, so
    data on masked-out clients never reaches the params."""
    _, train, _ = fed_data
    _, _, tr, tf = _configs(participation=0.5)
    data = _tt(train)
    poisoned = {k: v.clone() for k, v in data.items()}
    poisoned["acc"][1] = 1.0 - poisoned["acc"][1]
    poisoned["x"][3] += 5.0
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0])
    init = TMF.init_mf_router(torch.Generator().manual_seed(0), tr)
    fits = [TF.fedavg(torch.Generator().manual_seed(4), d, tr, tf, rounds=4,
                      init=init, loss_fn=TMF.mf_loss, client_mask=mask)[0]
            for d in (data, poisoned)]
    for a, b in zip(tree_leaves(fits[0]), tree_leaves(fits[1])):
        assert torch.equal(a, b)


def _mf_pair(fed_data, seed=2):
    """A reference MF fit and the port router holding its state."""
    split, _, _ = fed_data
    jr, jf, tr, _ = _configs(rounds=5)
    jm, _ = jrouters.fit_federated(jrouters.make("mf", jr), split["train"],
                                   jf, key=jax.random.PRNGKey(seed))
    return jm, routers.make("mf", tr, state=_t(jm.state))


@pytest.mark.parametrize("lam", [0.0, 0.5, 3.0])
def test_mf_route_is_the_utility_argmax(fed_data, lam):
    _, _, test = fed_data
    jm, tm = _mf_pair(fed_data)
    x = torch.from_numpy(test["x"][:300])
    got = tm.route(x, lam)
    assert got.dtype == torch.int32
    A, C = tm.predict(x)
    U = (A - lam * C).numpy()
    assert _near_tie_ok(got.numpy(), U.argmax(1), U).all()
    want = np.asarray(jm.route(jnp.asarray(test["x"][:300]), lam))
    assert _near_tie_ok(got.numpy(), want, U).all()


# ------------------------------------------------------------ onboarding


def _withheld_split(fed_data):
    """The fig. 4 protocol at small width: the last 2 of the 5 models are
    withheld from a fresh split of the reference's corpus; calibration is
    10% of each client's prompts evaluated on the withheld models."""
    corpus = jmake_eval_corpus(jax.random.PRNGKey(0), n_queries=1600,
                               n_tasks=4, n_models=M, d_emb=RK["d_emb"])
    split = jfederated_split(jax.random.PRNGKey(9), corpus,
                             JFedConfig(num_clients=4),
                             model_subset=list(range(M - 2)))
    rng = np.random.default_rng(0)
    q = np.concatenate([rng.choice(t, size=max(1, len(t) // 10),
                                   replace=False) for t in split["train_idx"]])
    acc_t, cost_t = (np.asarray(corpus[k]) for k in ("acc_table",
                                                     "cost_table"))
    x = np.asarray(corpus["x"])
    calib = {"x": np.concatenate([x[q]] * 2),
             "m": np.concatenate([np.full(len(q), M - 2 + j, np.int32)
                                  for j in range(2)]),
             "acc": np.concatenate([(rng.uniform(size=len(q))
                                     < acc_t[q, M - 2 + j]).astype(np.float32)
                                    for j in range(2)]),
             "cost": np.concatenate([cost_t[q, M - 2 + j] for j in range(2)]
                                    ).astype(np.float32),
             "w": np.ones(2 * len(q), np.float32)}
    test = {k: np.array(v) for k, v in split["test_global"].items()}
    return split, calib, test


@pytest.mark.parametrize("family", ["mlp", "mf"])
def test_model_onboarding_freezes_and_tracks_reference(fed_data, family):
    split, calib, test = _withheld_split(fed_data)
    jr, jf, tr, tf = _configs(rounds=3, lr=1e-2)
    jr3 = dataclasses.replace(jr, num_models=M - 2)
    tr3 = dataclasses.replace(tr, num_models=M - 2)
    jcal, tcal = jax.tree.map(jnp.asarray, calib), _tt(calib)
    for s in range(1):
        jb, _ = jrouters.fit_federated(jrouters.make(family, jr3),
                                       split["train"], jf,
                                       key=jax.random.PRNGKey(s))
        tb = routers.make(family, tr3, state=_t(jb.state))
        jo = jb.onboard_model(jcal, key=jax.random.PRNGKey(10 + s), fcfg=jf,
                              n_new=2, steps=300)
        to = tb.onboard_model(calib, gen=10 + s, fcfg=tf, n_new=2, steps=300)
        assert to.num_models == M
        frozen = "trunk" if family == "mlp" else "proj"
        for a, b in zip(tree_leaves(to.state[frozen]),
                        tree_leaves(tb.state[frozen])):
            assert torch.equal(a, b)
        for key in ("acc_w", "cost_w", "acc_b", "cost_b"):
            assert torch.equal(to.state["heads"][key][..., :M - 2],
                               tb.state["heads"][key])
        j_auc, t_auc = _auc_j(jo.predict, test), _auc_t(to.predict, test)
        assert abs(t_auc - j_auc) <= 0.02, (s, t_auc, j_auc)
        j_loss, t_loss = float(jo.loss(jcal)), float(to.loss(tcal))
        assert abs(t_loss - j_loss) <= 0.03 * j_loss, (s, t_loss, j_loss)


@pytest.mark.parametrize("family", ["mlp", "mf", "kmeans", "elo"])
def test_client_onboarding_tracks_reference(fed_data, family):
    """App. D.3 from the reference's fit on clients 0–1 (through
    ``client_mask``): the gradient families continue FedAvg on clients
    2–3 with distillation, the one-shot families merge their statistics
    (the same numbers as the reference's, to the Elo tolerance)."""
    split, train, test = fed_data
    jr, jf, tr, tf = _configs(rounds=3, participation=1.0, lr=3e-3)
    mask = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    new = {k: v[2:] for k, v in train.items()}
    for s in range(1):
        jb, _ = jrouters.fit_federated(jrouters.make(family, jr),
                                       split["train"], jf,
                                       key=jax.random.PRNGKey(s),
                                       client_mask=jnp.asarray(mask))
        tb = routers.make(family, tr, state=_t(jb.state))
        if family in ("mlp", "mf"):
            jo = jb.onboard_clients(jax.tree.map(jnp.asarray, new),
                                    key=jax.random.PRNGKey(20 + s), fcfg=jf,
                                    rounds=4)
            to = tb.onboard_clients(new, gen=20 + s, fcfg=tf, rounds=4)
        else:
            jo = jb.onboard_clients(jax.tree.map(jnp.asarray, new))
            to = tb.onboard_clients(new)
            _state_close(to.state, jo.state)
        j_auc, t_auc = _auc_j(jo.predict, test), _auc_t(to.predict, test)
        assert abs(t_auc - j_auc) <= 0.02, (s, t_auc, j_auc)


def _state_close(got: dict, want: dict):
    """Leaf by leaf |Δ| ≤ 1e-5·|ref| + 1e-5·max(1, max|ref|)."""
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(
            got[k].numpy(), w, rtol=1e-5,
            atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=k)


# ------------------------------------------------------------------- Elo


@pytest.fixture(scope="module")
def elo_ref(fed_data):
    """The reference's federated Elo router."""
    split, _, _ = fed_data
    return JEL.fed_elo_router(jax.random.PRNGKey(3), split["train"],
                              JRouterConfig(**RK))


def test_elo_statistics_from_the_reference_anchors(fed_data, elo_ref):
    split, train, test = fed_data
    jr, _, tr, _ = _configs()
    anchors, tau = elo_ref["anchors"], JEL._tau(jr)
    ta = torch.from_numpy(np.array(anchors))
    x = test["x"][:200]
    np.testing.assert_allclose(
        TEL.kernel_weights(torch.from_numpy(x), ta, TEL._tau(tr)).numpy(),
        np.asarray(JEL.kernel_weights(jnp.asarray(x), anchors, tau)),
        rtol=1e-5, atol=1e-5)
    ja, jc, jn = jax.vmap(lambda di: JEL._anchor_stats(anchors, di, M, tau))(
        split["train"])
    sa, sc, sn = TEL._anchor_stats(ta, _tt(train), M, TEL._tau(tr))
    for got, want in ((sa, ja), (sc, jc), (sn, jn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    jstate = JEL._build_state(anchors, *(jnp.sum(t, 0) for t in (ja, jc, jn)),
                              jr)
    tstate = TEL._build_state(ta, sa.sum(0), sc.sum(0), sn.sum(0), tr)
    _state_close(tstate, jstate)
    for got, want in zip(TEL.predict(tstate, torch.from_numpy(x)),
                         JEL.predict(jstate, jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    rng = np.random.default_rng(5)
    calib = {"x": test["x"][:150],
             "acc": (rng.uniform(size=150) > 0.4).astype(np.float32),
             "cost": rng.uniform(size=150).astype(np.float32),
             "w": np.ones(150, np.float32)}
    new = {k: v[:2] for k, v in train.items()}
    pairs = ((TEL.add_model_stats(tstate, _tt(calib), tr),
              JEL.add_model_stats(jstate, jax.tree.map(jnp.asarray, calib),
                                  jr)),
             (TEL.merge_client_stats(tstate, _tt(new), tr),
              JEL.merge_client_stats(jstate, jax.tree.map(jnp.asarray, new),
                                     jr)))
    for got, want in pairs:
        _state_close(got, want)


def test_fed_elo_auc_near_reference(fed_data):
    split, train, test = fed_data
    jr, jf, tr, tf = _configs()
    j_auc = [_auc_j(jrouters.fit_federated(
        jrouters.make("elo", jr), split["train"], jf,
        key=jax.random.PRNGKey(s))[0].predict, test) for s in range(8)]
    t_auc = []
    for s in range(8):
        r, hist = routers.fit_federated(routers.make("elo", tr), train, tf,
                                        gen=s, device="cpu")
        assert hist == {"loss": [], "eval": []}
        t_auc.append(_auc_t(r.predict, test))
    assert abs(np.mean(t_auc) - np.mean(j_auc)) <= 0.02, (t_auc, j_auc)
    with pytest.raises(ValueError, match="mesh"):
        routers.fit_federated(routers.make("elo", tr), train, tf, gen=0,
                              device="cpu", mesh=object())
    with pytest.raises(ValueError, match="rounds_per_sync|unsupported"):
        routers.fit_federated(routers.make("elo", tr), train, tf, gen=0,
                              device="cpu", rounds_per_sync=2)


def test_elo_prior_state_has_a_fitted_state_structure(fed_data, elo_ref):
    _, train, _ = fed_data
    _, _, tr, tf = _configs()
    prior = routers.make("elo", tr).init(0, device="cpu").state
    fitted, _ = routers.fit_federated(routers.make("elo", tr), train, tf,
                                      gen=1, device="cpu")
    jprior = JEL.prior_state(jax.random.PRNGKey(0), JRouterConfig(**RK))
    for other in (fitted.state, jprior, elo_ref):
        assert list(prior) == list(other)
        for k in prior:
            assert tuple(prior[k].shape) == tuple(np.shape(other[k]))
            assert str(prior[k].dtype).split(".")[-1] == \
                str(np.asarray(other[k]).dtype)
    assert float(prior["tau"]) == pytest.approx(float(jprior["tau"]))
    assert float(prior["n"].abs().sum()) == 0.0
    assert float(prior["rating"].std()) > 1.0        # the jitter is there


@pytest.mark.parametrize("lam", [0.0, 0.5, 3.0])
def test_elo_route_is_the_utility_argmax(fed_data, elo_ref, lam):
    _, _, test = fed_data
    jm = jrouters.make("elo", JRouterConfig(**RK), state=elo_ref)
    tm = routers.make("elo", RouterConfig(**RK), state=_t(elo_ref))
    x = torch.from_numpy(test["x"][:300])
    got = tm.route(x, lam)
    assert got.dtype == torch.int32
    A, C = tm.predict(x)
    U = (A - lam * C).numpy()
    assert _near_tie_ok(got.numpy(), U.argmax(1), U).all()
    want = np.asarray(jm.route(jnp.asarray(test["x"][:300]), lam))
    assert _near_tie_ok(got.numpy(), want, U).all()


# --------------------------------------------------------------- K-means


def test_masked_kmeans_fit_matches_reference(fed_data):
    split, train, test = fed_data
    jr, jf, tr, tf = _configs()
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    j_auc = [_auc_j(lambda x, st=JKR.fed_kmeans_router(
        jax.random.PRNGKey(s), split["train"], jr,
        client_mask=jnp.asarray(mask)): JKR.predict(st, x), test)
        for s in range(8)]
    t_auc = []
    w_kept = float((train["w"] * mask[:, None]).sum())
    for s in range(8):
        r, _ = routers.fit_federated(routers.make("kmeans", tr), train, tf,
                                     gen=s, device="cpu",
                                     client_mask=torch.from_numpy(mask))
        assert float(r.state["n"].sum()) == pytest.approx(w_kept)
        t_auc.append(_auc_t(r.predict, test))
    assert abs(np.mean(t_auc) - np.mean(j_auc)) <= 0.02, (t_auc, j_auc)


# -------------------------------------------------------- personalization


def _linear_predictor(rng, d):
    """The same (A, C) = (σ(xW), xV) predictor on both sides."""
    W = rng.standard_normal((d, M)).astype(np.float32) * 0.3
    V = rng.standard_normal((d, M)).astype(np.float32) * 0.3
    return ((lambda x: (jax.nn.sigmoid(x @ W), x @ V)),
            (lambda x: (torch.sigmoid(x @ torch.from_numpy(W)),
                        x @ torch.from_numpy(V))))


def test_personalization_matches_reference():
    rng = np.random.default_rng(11)
    d = 12
    fed_j, fed_t = _linear_predictor(rng, d)
    loc_j, loc_t = _linear_predictor(rng, d)
    data = _batch(rng, 60, d)
    data["m"] = np.where(data["m"] == 3, 1, data["m"]).astype(np.int32)
    jd, td = jax.tree.map(jnp.asarray, data), _tt(data)     # model 3 unseen
    for fn_j, fn_t in ((fed_j, fed_t), (loc_j, loc_t)):
        for got, want in zip(TPZ.calibration_errors(fn_t, td, M),
                             JPZ.calibration_errors(fn_j, jd, M)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
            assert np.isinf(got.numpy()[3])
    inf = np.inf
    e_fed = np.array([0.2, inf, 0.1, inf, 0.0, 0.3], np.float32)
    e_loc = np.array([0.1, 0.4, inf, inf, 0.0, 0.0], np.float32)
    w = TPZ.mixture_weights(torch.from_numpy(e_fed), torch.from_numpy(e_loc))
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(JPZ.mixture_weights(jnp.asarray(e_fed),
                                                  jnp.asarray(e_loc))))
    assert w.numpy()[1:4].tolist() == [1.0, 0.0, 0.0]
    pt, (wa_t, wc_t) = TPZ.make_personalized(fed_t, loc_t, td, M)
    pj, (wa_j, wc_j) = JPZ.make_personalized(fed_j, loc_j, jd, M)
    np.testing.assert_allclose(wa_t.numpy(), np.asarray(wa_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(wc_t.numpy(), np.asarray(wc_j), rtol=1e-6,
                               atol=1e-6)
    x = rng.standard_normal((30, d)).astype(np.float32)
    for got, want in zip(pt(torch.from_numpy(x)), pj(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# ----------------------------------------------------- secure aggregation


def _stack(rng, N=4):
    return {"w": torch.from_numpy(rng.standard_normal((N, 6, 3)).astype(
        np.float32)), "b": [torch.from_numpy(rng.standard_normal(
            (N, 3)).astype(np.float32))]}


@pytest.mark.parametrize("wts", [[3.0, 1.0, 2.0, 4.0], [3.0, 0.0, 2.0, 0.0]])
def test_secure_agg_one_aggregation(wts):
    """Scale 0: bit-identical to FedAvg. Scale 10: the masks cancel to
    float rounding, and the stream of the round's generator is untouched."""
    cp = _stack(np.random.default_rng(0))
    w = torch.tensor(wts)
    plain = tagg.FedAvgAggregator()(cp, w, None)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    zero = tagg.SecureAggAggregator(scale=0.0)(cp, w, gen)
    for a, b in zip(tree_leaves(plain), tree_leaves(zero)):
        assert torch.equal(a, b)
    masked = tagg.SecureAggAggregator(scale=10.0)(cp, w, gen)
    assert torch.equal(gen.get_state(), state)
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(plain), tree_leaves(masked)))
    assert 0.0 < d <= 1e-6 * 10.0 * len(wts), d


def test_secure_agg_fit_scale0_bit_identical_scale10_close(fed_data):
    _, train, _ = fed_data
    _, _, tr, tf = _configs(rounds=3)
    data = _tt(train)

    def fit(agg, rounds):
        return TF.fedavg(torch.Generator().manual_seed(2), data, tr, tf,
                         rounds=rounds, aggregator=agg)

    plain, zero = fit(None, 3), fit(tagg.SecureAggAggregator(scale=0.0), 3)
    for a, b in zip(tree_leaves(plain[0]), tree_leaves(zero[0])):
        assert torch.equal(a, b)
    assert plain[1]["loss"] == zero[1]["loss"]
    one, ten = fit(None, 1), fit(tagg.SecureAggAggregator(scale=10.0), 1)
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(one[0]), tree_leaves(ten[0])))
    n_active = round(tf.participation * tf.num_clients)
    assert 0.0 < d <= 1e-6 * 10.0 * n_active, d


def test_secure_aggregate_matches_reference_and_cancels():
    rng = np.random.default_rng(4)
    updates = [rng.standard_normal((5, 2)).astype(np.float32)
               for _ in range(3)]
    wts = [1.0, 2.0, 3.0]
    masked = [TSA.mask_update(17, i, 3, torch.from_numpy(updates[i]), wts[i],
                              scale=10.0) for i in range(3)]
    agg = TSA.secure_aggregate(masked, sum(wts))
    want = sum(w * u for w, u in zip(wts, updates)) / sum(wts)
    np.testing.assert_allclose(agg.numpy(), want, rtol=1e-4, atol=1e-5)
    assert float((masked[0] - wts[0] * torch.from_numpy(updates[0])
                  ).abs().max()) > 1.0          # the upload is masked
    # the server step on the same masked inputs equals the reference's
    arrs = [m.numpy() for m in masked]
    np.testing.assert_array_equal(
        TSA.secure_aggregate([torch.from_numpy(a) for a in arrs],
                             sum(wts)).numpy(),
        np.asarray(JSA.secure_aggregate([jnp.asarray(a) for a in arrs],
                                        sum(wts))))
