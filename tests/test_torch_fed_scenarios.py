"""The port's traffic scenarios and ``run_online_vs_frozen`` on the CPU,
against the JAX package.

The scenarios' draws are numpy ``default_rng`` in both packages, seeded
alike, so with the reference's corpus injected (the port module's
``make_eval_corpus`` monkeypatched to the JAX one, keyed by the same seed)
they must be bit-equal over a seed grid: the client mixtures, the
stragglers, every phase's arrivals, the outcome sequence, the test sets,
the calibration evals and the perturbed embeddings; ``PowerLawScenario``
and ``engine_chaos_schedule`` draw nothing else and are compared as they
are.

``run_online_vs_frozen`` additionally gets the reference's pool weights
(``init_params``) and router init (``MLPRouter.init``) injected. Its
accounting — requests served, harvested samples and bytes, syncs, router
version, pool size — must be equal; the phase-0 online AUC (the injected
init, before any sync) equal to 1e-6; every other AUC of the curves
within 0.1 of the reference's, because the syncs, the frozen local fits
and the onboarding draw their minibatches and participants from each
package's own generator (the widest gap measured over these seeds is
0.058).
"""
import jax
import numpy as np
import pytest
import torch

from repro import routers as jrouters
from repro.config import RouterConfig as JRouterConfig
from repro.data.synthetic import make_eval_corpus as jmake_eval_corpus
from repro.fed import faults as jfaults
from repro.fed import scenarios as jscen
from repro.models import init_params as jinit_params
from repro_torch import convert
from repro_torch.fed import faults as tfaults
from repro_torch.fed import scenarios as tscen
from repro_torch.routers.mlp import MLPRouter

torch.set_num_threads(1)

#: the AUC band of run_online_vs_frozen against the reference
AUC_BAND = 0.1

SMOKE = dict(n_clients=4, n_tasks=4, n_models=2, d_emb=16, n_queries=400,
             queries_per_phase=24, phases=2, test_queries=24)


@pytest.fixture()
def jax_corpus(monkeypatch):
    """The port's scenarios draw the reference's corpus for their seed."""
    monkeypatch.setattr(
        tscen, "make_eval_corpus",
        lambda gen, **kw: jmake_eval_corpus(
            jax.random.PRNGKey(gen.initial_seed()), **kw))


def _pair(cfg_kw, **kw):
    return (jscen.TrafficScenario(jscen.ScenarioConfig(**cfg_kw), **kw),
            tscen.TrafficScenario(tscen.ScenarioConfig(**cfg_kw), **kw))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("cfg_kw", [
    dict(SMOKE, seed=0),
    dict(SMOKE, seed=1, embed_sigma=0.3, phases=3),
    dict(seed=7, embed_sigma=0.5, drift=0.5, phases=3),
    dict(seed=3, n_clients=9, straggler_frac=0.5, queries_per_phase=200),
], ids=["smoke", "sigma0.3", "default-sigma0.5-drift0.5", "stragglers"])
def test_scenario_draws_match_jax(jax_corpus, cfg_kw):
    js, ts = _pair(cfg_kw, n_reserved_models=1)
    cfg = ts.cfg
    assert len(js.mixtures) == len(ts.mixtures) == cfg.phases
    for a, b in zip(js.mixtures, ts.mixtures):
        _eq(a, b)
    assert js.stragglers == ts.stragglers
    for p in range(cfg.phases):
        ev = ts.events(p)
        assert ev == js.events(p)
        _eq(js._x_phase[p], ts._x_phase[p])
        for c in range(cfg.n_clients):
            want, got = js.test_set(p, c), ts.test_set(p, c)
            for k in want:
                _eq(want[k], got[k])
        # the outcome sequence, along the arrivals of this phase
        for c, q, _ in ev:
            m = (q + c) % (cfg.n_models + 1)
            assert ts.observe(q, m) == js.observe(q, m)
            _eq(js.x(q, p), ts.x(q, p))
            assert ts.prompt(q) == js.prompt(q)
    if cfg.embed_sigma > 0:
        assert not np.array_equal(ts._x_phase[0], ts._x_phase[1])
    for m in range(cfg.n_models + 1):
        want, got = js.calib_for_model(m, n=64), ts.calib_for_model(m, n=64)
        for k in want:
            _eq(want[k], got[k])
            assert np.asarray(want[k]).dtype == got[k].dtype


@pytest.mark.parametrize("kw", [
    dict(n_clients=1200), dict(n_clients=50, zipf_a=0.7, churn=0.5,
                               queries_per_phase=300, phases=4, seed=5),
    dict(n_clients=2, churn=1.0, phases=2, seed=11)])
def test_power_law_matches_jax(kw):
    js, ts = jscen.PowerLawScenario(**kw), tscen.PowerLawScenario(**kw)
    for p in range(ts.phases):
        _eq(js.popularity(p), ts.popularity(p))
        _eq(js.events(p), ts.events(p))
    for cov in (0.5, 0.9, 1.0):
        assert ts.coverage_clients(cov) == js.coverage_clients(cov)
    for bad, match in ((dict(n_clients=1), "n_clients"),
                       (dict(zipf_a=0.0), "zipf_a"),
                       (dict(churn=1.5), "churn")):
        with pytest.raises(ValueError, match=match):
            tscen.PowerLawScenario(**bad)
    with pytest.raises(ValueError, match="coverage"):
        ts.coverage_clients(0.0)


_PLANS = [dict(seed=1, burst_rate=0.25, burst_max=3, storm_rate=0.3,
               storm_len=4, storm_deadline=5, cancel_rate=0.25,
               spike_rate=0.2, spike_scale=2),
          dict(seed=3, burst_rate=0.3, burst_max=5, storm_rate=0.4,
               storm_len=4, storm_deadline=6, cancel_rate=0.3,
               spike_rate=0.2, spike_scale=3),
          dict(seed=9)]


@pytest.mark.parametrize("plan_kw", _PLANS, ids=["p1", "p3", "zero"])
def test_engine_chaos_schedule_matches_jax(plan_kw):
    kw = dict(ticks=40, arrivals_per_tick=2, max_new=3, vocab=97,
              default_deadline=20, cancel_horizon=8)
    want = jscen.engine_chaos_schedule(jfaults.FaultPlan(**plan_kw), **kw)
    got = tscen.engine_chaos_schedule(tfaults.FaultPlan(**plan_kw), **kw)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert {k: v for k, v in a.items() if k != "toks"} == \
            {k: v for k, v in b.items() if k != "toks"}
        _eq(a["toks"], b["toks"])
        assert b["toks"].dtype == np.int32


def test_engine_chaos_schedule_deterministic_and_well_formed():
    """The twin of the reference's: the same plan gives the same schedule,
    with storm arrivals, cancel fates and spike ticks present."""
    plan = tfaults.FaultPlan(**_PLANS[0])
    ev_a = tscen.engine_chaos_schedule(plan, ticks=12, max_new=3, vocab=97)
    ev_b = tscen.engine_chaos_schedule(plan, ticks=12, max_new=3, vocab=97)
    assert len(ev_a) == len(ev_b) >= 12
    for a, b in zip(ev_a, ev_b):
        assert a["tick"] == b["tick"] and a["max_new"] == b["max_new"]
        assert a["deadline"] == b["deadline"]
        assert a["cancel_after"] == b["cancel_after"]
        np.testing.assert_array_equal(a["toks"], b["toks"])
    assert any(e["deadline"] == 5 for e in ev_a)
    assert any(e["cancel_after"] is not None for e in ev_a)
    assert any(e["max_new"] == 6 for e in ev_a)


def test_make_pool_shares_one_set_of_weights():
    sc = tscen.TrafficScenario(tscen.ScenarioConfig(**SMOKE),
                               n_reserved_models=1)
    pool = sc.make_pool(device="cpu")
    assert [pm.name for pm in pool] == ["sim-m0", "sim-m1"]
    assert all(pm.params is pool[0].params for pm in pool)
    assert [pm.cost_per_token for pm in pool] == \
        [float(c) for c in sc.corpus["model_cost"][:2]]
    extra = sc.pool_model(2, device="cpu")
    assert extra.name == "sim-m2" and extra.cfg == tscen.SIM_MODEL
    ref = sc.make_pool(device="cpu")[0].params
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(extra.params)):
        assert torch.equal(a, b)


def _inject_run(monkeypatch, seed, d_emb, n_models, scen_seed):
    """The reference's pool weights and router init, into the port."""
    jp = jinit_params(jax.random.PRNGKey(scen_seed + 1), jscen.SIM_MODEL)
    monkeypatch.setattr(
        tscen, "init_params",
        lambda gen, cfg, device=None: convert.model_params_from_numpy(
            jax.tree.map(np.asarray, jp), cfg, device=device))
    rcfg = JRouterConfig(d_emb=d_emb, num_models=n_models, hidden=(32, 32),
                         dropout=0.0)
    js0 = jrouters.make("mlp", rcfg).init(jax.random.PRNGKey(seed + 11))
    state = jax.tree.map(np.asarray, js0.state)
    monkeypatch.setattr(
        MLPRouter, "init", lambda self, gen, device=None: self.with_state(
            convert.router_state_from_numpy(state, device=device)))


@pytest.mark.parametrize("scen_seed", [0, 1, 2])
def test_run_online_vs_frozen_matches_jax(jax_corpus, monkeypatch,
                                          scen_seed):
    cfg_kw = dict(SMOKE, seed=scen_seed)
    kw = dict(onboard_phase=1, local_steps=60, capacity=64)
    want = jscen.run_online_vs_frozen(jscen.ScenarioConfig(**cfg_kw), **kw)
    _inject_run(monkeypatch, 0, SMOKE["d_emb"], SMOKE["n_models"], scen_seed)
    got = tscen.run_online_vs_frozen(tscen.ScenarioConfig(**cfg_kw),
                                     device="cpu", **kw)
    for k in ("requests_served", "harvested_samples", "harvest_bytes",
              "num_models_final", "syncs", "router_version"):
        assert got[k] == want[k], k
    assert got["num_models_final"] == 3
    assert abs(got["auc_online"][0] - want["auc_online"][0]) <= 1e-6
    for k in ("auc_online", "auc_frozen_local"):
        assert len(got[k]) == len(want[k]) == 2
        for a, b in zip(got[k], want[k]):
            assert abs(a - b) <= AUC_BAND, (k, got[k], want[k])


def test_online_scenario_smoke():
    """The reference's end-to-end smoke, the port alone: drift and
    mid-run onboarding through the whole serve → harvest → federate →
    hot-swap loop, deterministic from its seeds."""
    cfg = tscen.ScenarioConfig(**SMOKE, seed=0)
    m = tscen.run_online_vs_frozen(cfg, onboard_phase=1, local_steps=60,
                                   capacity=64, device="cpu")
    assert len(m["auc_online"]) == 2 and len(m["auc_frozen_local"]) == 2
    assert all(0.0 <= a <= 1.0 for a in m["auc_online"])
    assert all(0.0 <= a <= 1.0 for a in m["auc_frozen_local"])
    assert m["syncs"] >= 1
    assert m["num_models_final"] == 3
    assert m["harvested_samples"] > 0
    assert m["requests_served"] == m["harvested_samples"]
    assert tscen.run_online_vs_frozen(cfg, onboard_phase=1, local_steps=60,
                                      capacity=64, device="cpu") == m


def test_kmeans_cannot_cold_start():
    with pytest.raises(ValueError, match="cannot cold-start"):
        tscen.run_online_vs_frozen(tscen.ScenarioConfig(**SMOKE),
                                   family="kmeans", device="cpu")


def test_launch_drivers_and_routed_serving_run_on_cpu(capsys):
    from repro_torch import routed_serving
    from repro_torch.launch import fed_serve, fed_train
    m = fed_serve.main(["--clients", "3", "--phases", "2",
                        "--queries-per-phase", "16", "--secure-agg",
                        "--dp", "0.01", "--device", "cpu"])
    assert m["requests_served"] == m["harvested_samples"] > 0
    out = capsys.readouterr().out
    assert "federated syncs" in out and "final gap" in out
    r = fed_train.main(["--clients", "4", "--rounds", "2", "--queries",
                        "400", "--device", "cpu"])
    assert len(r["loss"]) == 2 and 0.0 <= r["auc"] <= 1.0
    assert "global-test AUC" in capsys.readouterr().out
    out = routed_serving.main(["--device", "cpu"])
    assert {r["model"] for r in out[0.0]["results"]} == {"yi-6b"}
    assert any(r["model"] == "qwen2-1.5b" for r in out[2.0]["results"])
    assert out[2.0]["total_cost"] < out[0.0]["total_cost"]
