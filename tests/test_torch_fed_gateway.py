"""The port's gateway hooks of the online loop against the JAX
``RoutedServer`` on the CPU: the harvest (``client_id``, ``routed_model``,
``report_outcome``, the zero-score record of an expiry, cancel and
shedding), failover under a ``FaultPlan``, and ``swap_router_state`` /
``add_model``.

Both servers hold the same two tiny f32 models (weights carried by
``convert``) behind the same MLP router, carried from the reference
through the checkpoint format (``Router.save`` → ``routers.load``); the
same requests with the same query embeddings go to both. Compared
exactly: the routed model of every request, its status, the error each
package raises for it, the counters, ``router_version`` and the harvest's
federated view bit for bit (the same scores, embeddings and costs go into
numpy rings on both sides). Routing decisions are argmax decisions, held
equal as everywhere in the port's serving tests.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import routers as jrouters
from repro.config import ModelConfig as JModelConfig
from repro.config import RouterConfig as JRouterConfig
from repro.fed.faults import FaultPlan as JFaultPlan
from repro.fed.harvest import HarvestStore as JHarvestStore
from repro.models import init_params as jinit_params
from repro.serve import gateway as jgateway
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch import convert, routers
from repro_torch.config import ModelConfig, RouterConfig
from repro_torch.fed import FaultPlan, HarvestStore
from repro_torch.serve import gateway as tgateway
from repro_torch.serve.engine import EngineConfig

torch.set_num_threads(1)

TINY = dict(name="fed-gw-tiny", arch_type="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=1, d_ff=64, vocab=97, head_dim=16,
            dtype="float32")
D_EMB = 16
RK = dict(d_emb=D_EMB, hidden=(16, 16), dropout=0.0)
COSTS = (0.1, 0.5, 0.3)
PROMPTS = ["the quick brown fox", "jumps over", "a lazy dog today ok fine",
           "one two three", "counting up to five now", "zig zag",
           "when in rome do as", "hello"]


def _pools(n):
    jcfg, tcfg = JModelConfig(**TINY), ModelConfig(**TINY)
    jpool, tpool = [], []
    for i in range(n):
        jp = jinit_params(jax.random.PRNGKey(10 + i), jcfg)
        jpool.append(jgateway.PoolModel(f"m{i}", jcfg, jp, COSTS[i]))
        tpool.append(tgateway.PoolModel(
            f"m{i}", tcfg, convert.model_params_from_numpy(
                jax.tree.map(np.asarray, jp), tcfg, device="cpu"), COSTS[i]))
    return jpool, tpool


def _routers(tmp_path, m, seed=1, **rk):
    """An MLP router over ``m`` models from the reference, and the port's
    copy loaded from its checkpoint."""
    kw = {**RK, **rk}
    jr = jrouters.make("mlp", JRouterConfig(num_models=m, **kw)).init(
        jax.random.PRNGKey(seed))
    path = tmp_path / f"router_{m}_{seed}.msgpack"
    jr.save(path)
    return jr, routers.load(path, RouterConfig(num_models=m, **kw),
                            device="cpu")


def _servers(tmp_path, ecfg, *, clients=3, jplan=None, tplan=None, **kw):
    jpool, tpool = _pools(2)
    jr, tr = _routers(tmp_path, 2)
    jsrv = jgateway.RoutedServer(
        jpool, jr, engine_cfg=JEngineConfig(**dataclasses.asdict(ecfg)),
        harvest=JHarvestStore(D_EMB, capacity=16, clients=range(clients)),
        fault_plan=jplan, **kw)
    tsrv = tgateway.RoutedServer(
        tpool, tr, engine_cfg=ecfg, device="cpu",
        harvest=HarvestStore(D_EMB, capacity=16, clients=range(clients),
                             device="cpu"), fault_plan=tplan, **kw)
    return jsrv, tsrv


def _outcome(fn):
    """fn's value, or the ValueError / RuntimeError it raises."""
    try:
        return ("ok", fn())
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def _score(rid, m):
    return ((7 * rid + 3 * m) % 10) / 10.0


def _same_harvest(jsrv, tsrv):
    want = jax.tree.map(np.asarray, jsrv.harvest.as_federated_data(
        pad_to=16))
    got = tsrv.harvest.as_federated_data(pad_to=16)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    return got


def _drive(srv, xs):
    """Deadlines, shedding (a queue cap of 4 per lane) and a cancel, then
    report every registered request's outcome."""
    rids = [srv.submit(PROMPTS[i % len(PROMPTS)], lam=(0.0, 2.0)[i % 2],
                       max_new_tokens=6, client_id=i % 3, x=xs[i],
                       deadline=1 if i in (2, 6) else None)
            for i in range(len(xs))]
    routed = [_outcome(lambda r=r: srv.routed_model(r)) for r in rids]
    first = srv.step()
    cancelled = srv.cancel(rids[5])
    done = srv.drain()
    statuses = [srv.status(r) for r in rids]
    reported = []
    for r, (kind, m) in zip(rids, routed):
        score = _score(r, m) if kind == "ok" else 1.0
        reported.append(_outcome(lambda r=r, s=score: srv.report_outcome(
            r, s)))
    after = [_outcome(lambda r=r: srv.routed_model(r)) for r in rids]
    return {"rids": rids, "routed": routed, "first": sorted(
        r for r, _ in first), "cancelled": cancelled, "done": sorted(done),
        "statuses": statuses, "reported": reported, "after": after,
        "counters": (srv.backend_failures, srv.expiry_failures,
                     srv.retries, srv.failovers)}


def test_harvest_under_deadlines_cancel_and_shedding(tmp_path):
    ecfg = EngineConfig(slots=2, max_seq=32, chunk=4, page_size=8,
                        queue_cap=4)
    jsrv, tsrv = _servers(tmp_path, ecfg)
    xs = np.random.default_rng(0).standard_normal((11, D_EMB)).astype(
        np.float32)
    want, got = _drive(jsrv, xs), _drive(tsrv, xs)
    assert got == want
    statuses = set(got["statuses"])
    assert {"EXPIRED", "CANCELLED", "SHED"} <= statuses
    assert {m for k, m in got["routed"] if k == "ok"} == {0, 1}
    data = _same_harvest(jsrv, tsrv)
    # one row per served or expired request, zero score for an expiry
    n_rows = sum(s in ("DONE", "EXPIRED") for s in got["statuses"])
    assert float(data["w"].sum()) == n_rows == len(tsrv.harvest)
    expired = [r for r, s in zip(got["rids"], got["statuses"])
               if s == "EXPIRED"]
    assert tsrv.expiry_failures == len(expired) > 0
    assert all(k == "ValueError" for k, _ in got["after"])
    for why in ("EXPIRED past its deadline", "cancelled or shed",
                "already reported"):
        assert any(why in m for _, m in got["after"])


def test_unregistered_and_evicted_rids(tmp_path, monkeypatch):
    """A rid submitted without client_id, and the pending cap's eviction
    (the cap lowered to 2 in both packages)."""
    ecfg = EngineConfig(slots=4, max_seq=32, chunk=4, page_size=8)
    jsrv, tsrv = _servers(tmp_path, ecfg)
    monkeypatch.setattr(jgateway, "PENDING_EVAL_CAP", 2)
    monkeypatch.setattr(tgateway, "PENDING_EVAL_CAP", 2)
    x = np.ones(D_EMB, np.float32)
    res = []
    for srv in (jsrv, tsrv):
        r0 = srv.submit("a b", max_new_tokens=4, x=x)
        rs = [srv.submit("c d e", max_new_tokens=4, x=x, client_id=1)
              for _ in range(3)]
        res.append([_outcome(lambda r=r: srv.routed_model(r))
                    for r in [r0] + rs])
        srv.drain()
    assert res[1] == res[0]
    assert res[1][0][1].endswith("submit() it with client_id= and attach "
                                 "a HarvestStore to track routing outcomes")
    assert "PENDING_EVAL_CAP=2" in res[1][1][1]


@pytest.mark.parametrize("plan,retries", [
    (dict(seed=0, fail_models=(0,)), 2),
    (dict(seed=3, backend_fail=0.5), 1),
    (dict(seed=4, backend_fail=0.3, fail_models=(1,)), 0),
    (dict(seed=0, fail_models=(0, 1)), 2)])
def test_failover_matches_reference(tmp_path, plan, retries):
    ecfg = EngineConfig(slots=4, max_seq=32, chunk=4, page_size=8)
    jsrv, tsrv = _servers(tmp_path, ecfg, jplan=JFaultPlan(**plan),
                          tplan=FaultPlan(**plan), max_retries=retries)
    xs = np.random.default_rng(1).standard_normal((8, D_EMB)).astype(
        np.float32)
    res = []
    for srv in (jsrv, tsrv):
        rids = [_outcome(lambda i=i: srv.submit(
            PROMPTS[i], lam=(0.0, 2.0)[i % 2], max_new_tokens=4,
            client_id=i % 3, x=xs[i])) for i in range(8)]
        routed = [_outcome(lambda r=r: srv.routed_model(r[1]))
                  if r[0] == "ok" else r for r in rids]
        srv.drain()
        res.append((routed, srv.backend_failures, srv.retries,
                    srv.failovers))
    assert res[1] == res[0]
    if plan.get("fail_models") == (0,):
        assert {m for _, m in res[1][0]} == {1} and res[1][3] > 0
    if plan.get("fail_models") == (0, 1):
        assert all(k == "RuntimeError" for k, _ in res[1][0])


def test_swap_router_state_and_add_model_match_reference(tmp_path):
    ecfg = EngineConfig(slots=4, max_seq=32, chunk=4, page_size=8)
    jsrv, tsrv = _servers(tmp_path, ecfg)
    xs = np.random.default_rng(2).standard_normal((16, D_EMB)).astype(
        np.float32)
    jr2, tr2 = _routers(tmp_path, 2, seed=5)
    jsrv.swap_router_state(jr2.state)
    tsrv.swap_router_state(tr2.state)
    assert tsrv.router_version == jsrv.router_version == 1
    for lam in (0.0, 0.5, 2.0):
        got = tsrv._route_x(xs, lam)
        np.testing.assert_array_equal(got, jsrv._route_x(xs, lam))
        np.testing.assert_array_equal(
            got, tr2.route(torch.from_numpy(xs), lam).numpy())

    # refusals: another shape, another structure, the wrong pool size
    jn, tn = _routers(tmp_path, 2, seed=6, hidden=(8, 16))
    jm, tm = _routers(tmp_path, 3, seed=7)
    cases = [("swap_router_state", jn.state, tn.state),
             ("swap_router_state", {"heads": jn.state["heads"]},
              {"heads": tn.state["heads"]}),
             ("add_model", None, None)]
    for name, js, ts in cases:
        if name == "add_model":
            want = _outcome(lambda: jsrv.add_model(jsrv.pool[0], jn))
            got = _outcome(lambda: tsrv.add_model(tsrv.pool[0], tn))
        else:
            want = _outcome(lambda: jsrv.swap_router_state(js))
            got = _outcome(lambda: tsrv.swap_router_state(ts))
        assert got == want and got[0] == "ValueError"
    # the port also refuses another dtype or device
    for bad in (lambda t: t.double(), lambda t: t.to("meta")):
        st = dict(tr2.state, heads=dict(tr2.state["heads"]))
        st["heads"]["acc_b"] = bad(st["heads"]["acc_b"])
        with pytest.raises(ValueError, match="swap_router_state"):
            tsrv.swap_router_state(st)
    assert tsrv.router_version == 1

    # onboard a third model with its expanded router
    jpool3, tpool3 = _pools(3)
    jsrv.add_model(jpool3[2], jm)
    tsrv.add_model(tpool3[2], tm)
    assert tsrv.router_version == jsrv.router_version == 2
    assert len(tsrv.pool) == len(tsrv.engine.pool) == 3
    want = jsrv.generate(PROMPTS, lam=0.0, max_new_tokens=4)
    got = tsrv.generate(PROMPTS, lam=0.0, max_new_tokens=4)
    assert got["routing"] == want["routing"]
    assert got["results"] == want["results"]
    assert 2 in got["routing"]
