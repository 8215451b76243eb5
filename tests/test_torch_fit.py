"""The port's federated MLP fit (Alg. 1) and its foundations against the
JAX reference on the CPU.

Inputs are drawn with numpy from a seed, or are the reference's own corpus
and split, and fed to both sides; reference params come into the port
through ``repro_torch.convert``.

Tolerances, stated per check:
  * params leaf by leaf to |Δ| ≤ rtol·|ref| + rtol·max|ref| (a relative
    tolerance on the leaf's scale: Adam divides by √v, so an element whose
    gradient is near 0 moves by amounts set by f32 rounding noise);
  * AdamW / SGD over one gradient sequence (8 steps): params to 1e-6;
  * ``router_loss`` with and without sample weights: 1e-6;
  * ``client_update`` on a stack of clients with uneven sizes (so some
    clients stop early) and an active clip, full batch: params to 1e-5,
    per-client mean loss to 1e-5 relative;
  * deterministic FedAvg (dropout 0, participation 1, ``full_batch``, the
    reference's init), 5 rounds with AdamW and with SGD: params and
    per-round loss to 1e-4;
  * a model head appended for onboarding leaves the other columns'
    predictions as they were, to 1e-6;
  * stochastic FedAvg (dropout, minibatches, participation 0.6): the mean
    frontier AUC over 4 seeds within 0.03 of the reference's mean over 4
    keys (one fit's AUC spreads by ~0.02 across seeds on either side);
  * ``policy.frontier`` to 1e-6, ``frontier_auc`` exactly;
  * corpus and split: shapes and statistics; on the reference's corpus
    the split's client assignment equals the reference's.
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
from repro.core import federated as JF
from repro.core import mlp_router as JR
from repro.core import policy as JP
from repro.data.partition import federated_split as jfederated_split
from repro.data.synthetic import make_eval_corpus as jmake_eval_corpus
from repro.fed import aggregators as jagg
from repro.train import optim as jopt
from repro_torch import convert, routers
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.core import federated as TF
from repro_torch.core import mlp_router as TR
from repro_torch.core import policy as TP
from repro_torch.data.partition import client_slice, federated_split
from repro_torch.data.synthetic import make_eval_corpus
from repro_torch.fed import aggregators as tagg
from repro_torch.train import optim as topt

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return convert.router_state_from_numpy(_np(tree), device="cpu")


def _close(got, want, rtol):
    """Leaf by leaf |Δ| ≤ rtol·|ref| + rtol·max|ref of the leaf|."""
    def one(w, g):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()))
    jax.tree.map(one, _np(want), convert.state_to_numpy(got))


# --------------------------------------------------------------- optimizers


@pytest.mark.parametrize("name,clip", [("adamw", None), ("adamw", 0.5),
                                       ("sgd", None), ("sgd", 0.5)])
def test_optimizer_matches_reference(name, clip):
    rng = np.random.default_rng(0)
    params = {"trunk": [{"w": rng.standard_normal((6, 5)).astype(np.float32),
                         "b": rng.standard_normal(5).astype(np.float32)}],
              "heads": {"acc_w": rng.standard_normal((5, 3)).astype(
                  np.float32)}}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params) for _ in range(8)]
    if name == "adamw":
        jo = jopt.AdamW(lr=1e-2, weight_decay=3e-4, clip_norm=clip)
        to = topt.AdamW(lr=1e-2, weight_decay=3e-4, clip_norm=clip)
    else:
        jo, to = jopt.SGD(lr=1e-2, clip_norm=clip), topt.SGD(lr=1e-2,
                                                             clip_norm=clip)
    jp, tp = jax.tree.map(jnp.asarray, params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(_t(g), ts, tp)
    _close(tp, jp, rtol=1e-6)


def test_batched_optimizer_clips_and_steps_per_client():
    """Stacked params with one step count per client: each client's result
    equals its own unbatched run (clip norm per client)."""
    rng = np.random.default_rng(1)
    N = 3
    p = {"w": torch.from_numpy(rng.standard_normal((N, 4, 2)).astype(
        np.float32))}
    grads = [{"w": torch.from_numpy(rng.standard_normal((N, 4, 2)).astype(
        np.float32)) * (i + 1)} for i in range(4)]
    opt = topt.AdamW(lr=1e-2, clip_norm=0.3)
    state = opt.init(p, batch=N)
    pb = p
    for g in grads:
        pb, state = opt.update(g, state, pb)
    for i in range(N):
        pi, si = {"w": p["w"][i]}, opt.init({"w": p["w"][i]})
        for g in grads:
            pi, si = opt.update({"w": g["w"][i]}, si, pi)
        np.testing.assert_allclose(pb["w"][i].numpy(), pi["w"].numpy(),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- the loss


def _batch(rng, B, d, M):
    return {"x": rng.standard_normal((B, d)).astype(np.float32),
            "m": rng.integers(0, M, B).astype(np.int32),
            "acc": (rng.uniform(size=B) > 0.5).astype(np.float32),
            "cost": rng.uniform(size=B).astype(np.float32),
            "w": (np.arange(B) < B - 5).astype(np.float32)}


@pytest.mark.parametrize("weighted", [True, False])
def test_router_loss_matches_reference(weighted):
    jcfg = JRouterConfig(d_emb=12, num_models=4, hidden=(16, 8), dropout=0.0)
    tcfg = RouterConfig(d_emb=12, num_models=4, hidden=(16, 8), dropout=0.0)
    params = JR.init_mlp_router(jax.random.PRNGKey(0), jcfg)
    batch = _batch(np.random.default_rng(2), 33, 12, 4)
    if not weighted:
        del batch["w"]
    want = JR.router_loss(params, jax.tree.map(jnp.asarray, batch), jcfg)
    got = TR.router_loss(_t(params), {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_router_loss_method_and_model_head_onboarding():
    cfg = RouterConfig(d_emb=12, num_models=4, hidden=(16, 8), dropout=0.0)
    r = routers.make("mlp", cfg).init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(np.random.default_rng(5), 20, 12, 4).items()}
    assert torch.equal(r.loss(batch), TR.router_loss(r.state, batch, cfg))
    grown = TR.add_model_head(r.state, torch.Generator().manual_seed(1))
    for k in ("acc_w", "cost_w", "acc_b", "cost_b"):
        old, new = r.state["heads"][k], grown["heads"][k]
        assert new.shape[-1] == old.shape[-1] + 1
        assert torch.equal(new[..., :-1], old)
    assert float(grown["heads"]["acc_b"][-1]) == 0.0
    assert float(grown["heads"]["acc_w"][:, -1].abs().sum()) > 0.0
    A, C = TR.apply_mlp_router(grown, batch["x"])
    A0, C0 = r.predict(batch["x"])
    assert A.shape == (20, 5)
    torch.testing.assert_close(A[:, :4], A0, rtol=1e-6, atol=1e-6)


def test_dropout_is_inverted_and_drawn_from_the_generator():
    cfg = RouterConfig(d_emb=8, num_models=2, hidden=(4000,), dropout=0.25)
    p = TR.init_mlp_router(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((3, 8), generator=torch.Generator().manual_seed(1))
    h0 = TR.trunk_apply(p, x)
    h1 = TR.trunk_apply(p, x, dropout=0.25,
                        gen=torch.Generator().manual_seed(2))
    h2 = TR.trunk_apply(p, x, dropout=0.25,
                        gen=torch.Generator().manual_seed(2))
    kept = h1 != 0
    assert torch.equal(h1, h2)
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    torch.testing.assert_close(h1[kept], h0[kept] / 0.75)


# --------------------------------------------------------------- FedAvg


@pytest.fixture(scope="module")
def fed_data():
    """A reference corpus and split at d_emb 32, 4 clients."""
    fcfg = JFedConfig(num_clients=4)
    corpus = jmake_eval_corpus(jax.random.PRNGKey(0), n_queries=4000,
                               d_emb=32)
    split = jfederated_split(jax.random.PRNGKey(1), corpus, fcfg)
    return corpus, split


def _configs(**fed):
    """Matching (reference, port) router and fed configs."""
    rk = dict(d_emb=32, num_models=11, hidden=(64, 64))
    fk = dict(num_clients=4, **fed)
    return (JRouterConfig(**rk), JFedConfig(**fk), RouterConfig(**rk),
            FedConfig(**fk))


def test_client_update_stops_each_client_at_its_own_steps():
    """Full-batch local steps on 3 clients of 100, 300 and 500 rows with a
    batch size of 128: they stop after 1, 3 and 4 of the 4 steps (params
    and optimizer state frozen after that), with the clip active."""
    jr, jf, tr, tf = _configs(clip_norm=0.05, lr=1e-2)
    rng = np.random.default_rng(3)
    D = 500
    data = _batch(rng, D, 32, 11)
    data = {k: np.stack([v] * 3) for k, v in data.items()}
    data["w"] = (np.arange(D)[None] < np.array([100, 300, 500])[:, None]
                 ).astype(np.float32)
    params = JR.init_mlp_router(jax.random.PRNGKey(4), jr)
    opt = JF._make_opt(jf, "adamw")
    upd = lambda d, k: JF.client_update(params, d, k, jr, jf, opt, 4,
                                        full_batch=True)
    jp, jl = jax.vmap(upd)(jax.tree.map(jnp.asarray, data),
                           jax.random.split(jax.random.PRNGKey(5), 3))
    tp, tl = TF.client_update(_t(params), {k: torch.from_numpy(v)
                                           for k, v in data.items()},
                              None, tr, tf, TF._make_opt(tf, "adamw"), 4,
                              full_batch=True)
    _close(tp, jp, rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


@pytest.mark.parametrize("optimizer,lr", [("adamw", 1e-3), ("sgd", 0.3)])
def test_deterministic_fedavg_matches_reference(fed_data, optimizer, lr):
    _, split = fed_data
    jr, jf, tr, tf = _configs(participation=1.0, lr=lr)
    jr, tr = (dataclasses.replace(c, dropout=0.0) for c in (jr, tr))
    init = JR.init_mlp_router(jax.random.PRNGKey(6), jr)
    jp, jh = JF.fedavg(jax.random.PRNGKey(7), split["train"], jr, jf,
                       rounds=5, init=init, full_batch=True,
                       optimizer=optimizer)
    train = {k: torch.from_numpy(np.array(v)) for k, v in
             split["train"].items()}
    tp, th = TF.fedavg(torch.Generator().manual_seed(7), train, tr, tf,
                       rounds=5, init=_t(init), full_batch=True,
                       optimizer=optimizer)
    _close(tp, jp, rtol=1e-4)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert th["loss"][-1] < th["loss"][0]


def test_fedavg_aggregator_matches_reference():
    rng = np.random.default_rng(8)
    stack = {"a": rng.standard_normal((4, 3, 2)).astype(np.float32),
             "b": [rng.standard_normal((4, 5)).astype(np.float32)]}
    wts = np.array([10.0, 0.0, 3.0, 7.0], np.float32)
    want = jagg.FedAvgAggregator()(jax.tree.map(jnp.asarray, stack),
                                   jnp.asarray(wts), jax.random.PRNGKey(0))
    got = tagg.FedAvgAggregator()(_t(stack), torch.from_numpy(wts), None)
    _close(got, want, rtol=1e-6)
    noisy = tagg.GaussianDPAggregator(sigma=0.1)(
        _t(stack), torch.from_numpy(wts), torch.Generator().manual_seed(0))
    dev = noisy["a"] - got["a"]
    assert 0.0 < float(dev.abs().max()) < 0.6


def _auc_t(router, test):
    return TP.eval_router(router.predict, *(torch.from_numpy(test[k]) for k in
                                            ("x", "acc_table",
                                             "cost_table")))[2]


def test_stochastic_fedavg_auc_near_reference(fed_data):
    _, split = fed_data
    jr, jf, tr, tf = _configs(rounds=5, local_epochs=3, lr=3e-3)
    test = {k: np.array(v) for k, v in split["test_global"].items()}
    train = {k: np.array(v) for k, v in split["train"].items()}
    j_auc, t_auc = [], []
    for s in range(4):
        jm, _ = jrouters.fit_federated(jrouters.make("mlp", jr),
                                       split["train"], jf,
                                       key=jax.random.PRNGKey(s))
        j_auc.append(JP.eval_router(jm.predict, test["x"], test["acc_table"],
                                    test["cost_table"])[2])
        tm, hist = routers.fit_federated(routers.make("mlp", tr), train, tf,
                                         gen=s, device="cpu")
        assert len(hist["loss"]) == 5 and hist["loss"][-1] < hist["loss"][0]
        t_auc.append(_auc_t(tm, test))
    assert abs(np.mean(t_auc) - np.mean(j_auc)) <= 0.03, (t_auc, j_auc)


def test_fit_local_and_eval_hooks(fed_data):
    _, split = fed_data
    _, _, tr, tf = _configs(rounds=3)
    test = {k: np.array(v) for k, v in split["test_global"].items()}
    train = {k: np.array(v) for k, v in split["train"].items()}
    local, hist = routers.fit_local(routers.make("mlp", tr),
                                    client_slice(train, 0), tf, gen=0,
                                    steps=60, device="cpu")
    assert len(hist["loss"]) == 60
    assert np.mean(hist["loss"][-10:]) < np.mean(hist["loss"][:10])
    seen = []
    fed, hist = routers.fit_federated(
        routers.make("mlp", tr), train, tf, gen=1, device="cpu",
        eval_fn=lambda r: seen.append(r.num_models) or _auc_t(r, test),
        eval_every=2)
    assert seen == [11, 11] and len(hist["eval"]) == 2
    with pytest.raises(TypeError, match="mesh"):
        routers.fit_federated(routers.make("mlp", tr), train, tf, gen=1,
                              device="cpu", mesh=object())
    _, hist = routers.fit_federated(routers.make("mlp", tr), train, tf,
                                    gen=1, device="cpu", cohort=2, rounds=1)
    assert len(hist["loss"]) == 1
    with pytest.raises(ValueError, match="gen= and fcfg="):
        fed.onboard_model({})


# ------------------------------------------------------------------ policy


def test_frontier_matches_reference():
    rng = np.random.default_rng(9)
    Q, M = 400, 7
    A, C = (rng.uniform(size=(Q, M)).astype(np.float32) for _ in range(2))
    acc, cost = (rng.uniform(size=(Q, M)).astype(np.float32)
                 for _ in range(2))
    jc, ja = JP.frontier(*map(jnp.asarray, (A, C, acc, cost)))
    tc, ta = TP.frontier(*map(torch.from_numpy, (A, C, acc, cost)))
    assert tc.dtype == ta.dtype == np.float32 and tc.shape == (100,)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-6)
    assert TP.frontier_auc(jc, ja) == JP.frontier_auc(jc, ja)
    np.testing.assert_array_equal(TP.lambda_grid(), JP.lambda_grid())
    np.testing.assert_array_equal(
        TP.route(torch.from_numpy(A), torch.from_numpy(C), 0.7).numpy(),
        np.asarray(JP.route(jnp.asarray(A), jnp.asarray(C), 0.7)))


# -------------------------------------------------------- corpus and split


def test_corpus_statistics():
    c = make_eval_corpus(torch.Generator().manual_seed(0), n_queries=3000,
                         n_tasks=8, n_models=11, d_emb=24)
    assert c["x"].shape == (3000, 24) and c["acc_table"].shape == (3000, 11)
    assert c["task"].min() >= 0 and c["task"].max() < 8
    counts = torch.bincount(c["task"], minlength=8).float()
    assert float(counts.min()) > 3000 / 8 * 0.8
    assert torch.all((c["acc_table"] > 0) & (c["acc_table"] < 1))
    assert torch.all((c["cost_table"] >= 0) & (c["cost_table"] <= 1))
    assert torch.all(c["model_cost"][1:] > c["model_cost"][:-1])
    # queries sit at noise 0.45 around task centroids of radius 2.5
    mu = torch.stack([c["x"][c["task"] == t].mean(0) for t in range(8)])
    np.testing.assert_allclose(torch.linalg.norm(mu, dim=1).numpy(), 2.5,
                               atol=0.1)
    # the more expensive half of the pool is more accurate on average
    acc = c["acc_table"].mean(0)
    assert float(acc[6:].mean()) > float(acc[:5].mean())


def test_split_follows_the_reference_partition(fed_data):
    """On the reference's corpus, the numpy part of the split (clients,
    shuffles, logged models) equals the reference's; the observed
    outcomes are fresh torch draws with the right statistics."""
    corpus, split = fed_data
    tc = {k: (torch.from_numpy(np.array(v)) if hasattr(v, "shape") else v)
          for k, v in corpus.items()}
    ts = federated_split(torch.Generator().manual_seed(1), tc,
                         FedConfig(num_clients=4))
    jt = split["train"]
    tt = ts["train"]
    assert {k: tuple(v.shape) for k, v in tt.items()} == \
        {k: tuple(v.shape) for k, v in jt.items()}
    for a, b in zip(ts["train_idx"], split["train_idx"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts["logging_p"], split["logging_p"])
    for k in ("x", "m", "w"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
    np.testing.assert_array_equal(ts["test_global"]["x"].numpy(),
                                  np.asarray(split["test_global"]["x"]))
    w = tt["w"] > 0
    acc = tt["acc"][w]
    assert set(acc.unique().tolist()) <= {0.0, 1.0}
    # Bernoulli draws of the logged pairs' success probabilities
    idx = np.concatenate(ts["train_idx"])
    p = tc["acc_table"][idx, tt["m"][w].long()]
    assert abs(float(acc.mean() - p.mean())) < 0.03
    cost_true = tc["cost_table"][idx, tt["m"][w].long()]
    noise = tt["cost"][w] - cost_true
    assert abs(float(noise.mean())) < 0.005
    assert 0.015 < float(noise.std()) < 0.025
