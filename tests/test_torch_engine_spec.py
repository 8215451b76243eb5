"""Speculative decode in the PyTorch engine, on the CPU.

Case by case the counterpart of ``tests/test_engine_spec.py``: a
speculative engine (``EngineConfig.spec_k > 0``) emits exactly the
non-speculative engine's tokens for every drafter pairing, in both pool
regimes; a drafter equal to the target accepts every draft; all-rejected
rounds still commit one token each; verify windows straddling page
boundaries leak no page; preemption, cancel and expiry with unverified
drafts in flight surface only committed tokens; and the gateway pairs a
request with the router's best strictly cheaper drafter. The reference
pins "zero decode retraces"; the port's bar is that the target's and the
drafters' pools are the same storage before and after. Beyond the
reference suite: the port engine's speculative tokens and counters equal
the JAX engine's on the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import routers as jrouters
from repro.config import RouterConfig as JRouterConfig
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.serve import engine as jengine
from repro.serve import gateway as jgateway
from repro_torch import convert, routers
from repro_torch.config import ModelConfig, RouterConfig
from repro_torch.configs import get_config
from repro_torch.serve.engine import (CANCELLED, EXPIRED, PREEMPTED_RESUMED,
                                      EngineConfig, Outcome, ServeEngine)
from repro_torch.serve.gateway import PoolModel, RoutedServer, make_pool_model

torch.set_num_threads(1)

TGT = ModelConfig(name="spec-tgt", arch_type="dense", n_layers=2,
                  d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=97,
                  head_dim=16)
#: independent tiny drafter: different seed AND depth — near-zero
#: agreement with the target, so it exercises the rejection path hard
DRF = ModelConfig(name="spec-drf", arch_type="dense", n_layers=1,
                  d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=97,
                  head_dim=16)
SSM = ModelConfig(name="spec-ssm", arch_type="ssm", n_layers=1,
                  d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=97,
                  head_dim=16)


@pytest.fixture(scope="module")
def pool():
    return [make_pool_model("spec-tgt", TGT, 1.0, gen=0, device="cpu"),
            make_pool_model("spec-drf", DRF, 0.2, gen=7, device="cpu")]


def _toks(seed, n):
    return np.random.default_rng(seed).integers(
        1, TGT.vocab, size=n).astype(np.int32)


REQS = [(_toks(10 + i, 3 + 2 * i), 6 + 3 * i) for i in range(4)]


def _run(pool, ecfg, reqs=REQS, draft=None):
    eng = ServeEngine(pool, ecfg, device="cpu")
    rids = [eng.submit(0, t, m, draft=draft) for t, m in reqs]
    out = eng.drain()
    return {r: np.asarray(out[r]) for r in rids}, eng


def _ecfg(paged, **kw):
    base = dict(slots=4, max_seq=64, chunk=4)
    if paged:
        base.update(page_size=4, pages=80)
    else:
        base.update(page_size=None)
    base.update(kw)
    return EngineConfig(**base)


def _storage(eng):
    pools = [lane.pool for lane in eng._lanes.values()] + [
        p for lane in eng._lanes.values() for p in lane.draft_pools.values()]
    return [t.data_ptr() for p in pools for layer in p.values()
            for t in layer.values()]


def _assert_pool_recovered(eng):
    for lane in eng._lanes.values():
        assert sorted(lane.free) == list(range(eng.ecfg.slots))
        assert not lane.active and not lane.queue
        assert (lane.tok == 0).all() and (lane.pos == 0).all()
        if lane.paged:
            assert sorted(lane.pt.free) == \
                list(range(1, eng.ecfg.resolved_pages + 1))
            assert not lane.pt._held and (lane.pt.table == 0).all()


# --------------------------------------------------------------- parity
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("spec_k", [1, 3, 5])
def test_spec_tokens_bit_identical_to_nonspec(pool, paged, spec_k):
    """Every request's tokens from the speculative engine equal the
    non-speculative engine's, in both pool regimes, for self-drafting
    (full acceptance) and an independent drafter (heavy rejection)."""
    ref, _ = _run(pool, _ecfg(paged))
    for draft in (0, 1):
        out, eng = _run(pool, _ecfg(paged, spec_k=spec_k), draft=draft)
        for r in ref:
            np.testing.assert_array_equal(ref[r], out[r])
        c = eng.counters()
        assert c["spec_rounds"] > 0
        assert c["spec_drafted"] == c["spec_accepted"] + c["spec_rejected"]
        _assert_pool_recovered(eng)


@pytest.mark.parametrize("paged", [False, True])
def test_self_draft_full_acceptance(pool, paged):
    """draft == target accepts every draft; a position the drafter failed
    to ingest (e.g. the verify's bonus token taken as the carry) would
    break this from round two on."""
    out, eng = _run(pool, _ecfg(paged, spec_k=3), draft=0)
    c = eng.counters()
    assert c["spec_drafted"] > 0
    assert c["spec_accepted"] == c["spec_drafted"]
    assert c["spec_rejected"] == 0


@pytest.mark.parametrize("paged", [False, True])
def test_all_k_rejected_degenerates_to_plain_step(pool, paged):
    """Rounds with zero accepted drafts still commit one correct token
    each (the verify's own argmax), so progress never stalls."""
    out, eng = _run(pool, _ecfg(paged, spec_k=3), draft=1)
    c = eng.counters()
    assert c["spec_rejected"] > 0
    assert sum(len(v) for v in out.values()) == sum(m for _, m in REQS)
    assert c["spec_rounds"] >= max(m for _, m in REQS)


def test_page_boundary_straddle_no_page_leaks(pool):
    """spec_k not dividing page_size: verify windows straddle page
    boundaries every round and near the region end poke past the last
    claimed page (into the trash page). After drain the page pool is
    whole."""
    ecfg = EngineConfig(slots=3, max_seq=64, chunk=4, page_size=4,
                        pages=60, spec_k=3)
    ref, _ = _run(pool, _ecfg(True))
    out, eng = _run(pool, ecfg, draft=0)
    for r in ref:
        np.testing.assert_array_equal(ref[r], out[r])
    _assert_pool_recovered(eng)


def test_spec_zero_decode_retraces(pool):
    """Acceptance variation is data, never shape: on one engine, replaying
    rejection-heavy and acceptance-heavy traffic allocates no pool — the
    target's and drafters' pools stay the same storage."""
    eng = ServeEngine(pool, _ecfg(True, spec_k=3), device="cpu")

    def run():
        rids = [eng.submit(0, t, m, draft=d) for d in (0, 1)
                for t, m in REQS]
        out = eng.drain()
        return [out[r] for r in rids]

    first = run()
    storage = _storage(eng)
    assert len(eng._lanes[0].draft_pools) == 2
    second = run()
    assert _storage(eng) == storage
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- lifecycle edge cases
def test_preemption_with_unverified_drafts_resumes_bit_identical(pool):
    """Preemption between spec rounds drops the uncommitted drafts; the
    resumed request re-prefills prompt + committed tokens (through the
    drafter too) and ends equal to its never-preempted twin."""
    ecfg = EngineConfig(slots=3, max_seq=32, chunk=4, page_size=4,
                        pages=8, reserve="initial", spec_k=3)
    ref_ecfg = EngineConfig(slots=3, max_seq=32, chunk=4, page_size=4,
                            pages=80)
    reqs = [(_toks(50 + i, 5 + i), 12) for i in range(3)]
    ref, _ = _run(pool, ref_ecfg, reqs=reqs)
    eng = ServeEngine(pool, ecfg, device="cpu")
    rids = [eng.submit(0, t, m, draft=0) for t, m in reqs]
    out = eng.drain()
    assert eng.preemptions > 0, "schedule failed to force a preemption"
    resumed = 0
    for rid, ref_rid in zip(rids, ref):
        np.testing.assert_array_equal(np.asarray(out[rid]), ref[ref_rid])
        resumed += eng.status(rid) == PREEMPTED_RESUMED
    assert resumed > 0
    _assert_pool_recovered(eng)


@pytest.mark.parametrize("terminal", ["cancel", "expire"])
def test_cancel_expire_mid_draft_discards_uncommitted(pool, terminal):
    """A request cancelled or expired between spec rounds surfaces ONLY
    committed tokens — a prefix of its solo tokens — though its drafts
    were already written into both pools."""
    solo, _ = _run(pool, _ecfg(True), reqs=[(REQS[0][0], 12)])
    solo_tokens = next(iter(solo.values()))
    eng = ServeEngine(pool, _ecfg(True, spec_k=3), device="cpu")
    if terminal == "cancel":
        rid = eng.submit(0, REQS[0][0], 12, draft=0)
        eng.step()
        eng.step()
        assert eng.cancel(rid) == CANCELLED
        want = CANCELLED
    else:
        rid = eng.submit(0, REQS[0][0], 12, deadline=2, draft=0)
        eng.step()
        eng.step()
        eng.step()
        want = EXPIRED
    out = eng.drain()
    payload = out[rid]
    assert isinstance(payload, Outcome) and payload.status == want
    n = len(payload.tokens)
    assert 0 < n < 12
    np.testing.assert_array_equal(payload.tokens, solo_tokens[:n])
    _assert_pool_recovered(eng)


# ------------------------------------------------------ API validation
def test_draft_requires_spec_mode(pool):
    eng = ServeEngine(pool, _ecfg(False), device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        eng.submit(0, _toks(1, 4), 4, draft=1)
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(pool, _ecfg(False, draft=1), device="cpu")
    with pytest.raises(ValueError, match="pool index"):
        ServeEngine(pool, _ecfg(False, spec_k=2, draft=5), device="cpu")
    with pytest.raises(ValueError, match="negative"):
        ServeEngine(pool, _ecfg(False, spec_k=-1), device="cpu")


def test_bad_drafters_rejected(pool):
    eng = ServeEngine(pool, _ecfg(False, spec_k=2), device="cpu")
    with pytest.raises(ValueError, match="pool index"):
        eng.submit(0, _toks(1, 4), 4, draft=9)
    small_vocab = ModelConfig(name="spec-vmismatch", arch_type="dense",
                              n_layers=1, d_model=32, n_heads=2,
                              n_kv_heads=1, d_ff=64, vocab=31, head_dim=16)
    pool4 = pool + [make_pool_model("vm", small_vocab, 0.1, gen=3,
                                    device="cpu"),
                    PoolModel("ssm", SSM, {}, 0.1)]
    eng4 = ServeEngine(pool4, _ecfg(False, spec_k=2), device="cpu")
    with pytest.raises(ValueError, match="token space"):
        eng4.submit(0, _toks(1, 4), 4, draft=2)
    with pytest.raises(TypeError, match="drafter"):
        eng4.submit(0, _toks(1, 4), 4, draft=3)


# ------------------------------------------- gateway: routing + drain()
def _make_server(pool, ecfg):
    router = routers.make(
        "kmeans", RouterConfig(d_emb=16, num_models=2),
        state={"centroids": torch.zeros((1, 16)),
               "A": torch.tensor([[0.9, 0.5]]),
               "C": torch.tensor([[1.0, 0.2]]), "n": torch.ones((1, 2))})
    return RoutedServer(pool, router, engine_cfg=ecfg, device="cpu")


def test_gateway_routes_cheaper_drafter(pool):
    """The expensive target drafts with the cheap model, the cheap target
    with itself (nothing cheaper exists); ``draft_model`` needs a
    speculative engine."""
    srv = _make_server(pool, _ecfg(True, spec_k=3))
    x = np.zeros(16, np.float32)
    assert srv._pick_draft(0, x, 0.5) == 1
    assert srv._pick_draft(1, x, 0.5) == 1
    with pytest.raises(ValueError, match="spec"):
        _make_server(pool, _ecfg(True)).submit("a b", draft_model=1)


def test_gateway_drain_rids_passthrough(pool):
    """Draining one stream through the gateway leaves the other's results
    on the engine."""
    srv = _make_server(pool, _ecfg(True))
    ra = srv.submit("stream one alpha", max_new_tokens=6)
    rb = srv.submit("stream two beta gamma", max_new_tokens=7)
    out_a = srv.drain(rids=[ra])
    assert ra in out_a and rb not in out_a
    out_b = srv.drain([rb])
    assert rb in out_b and out_b[rb].shape == (7,)
    assert srv.drain() == {}


def test_spec_counters_flow_through_gateway(pool):
    srv = _make_server(pool, _ecfg(True, spec_k=3))
    # λ 0.1 routes to the expensive target (utility 0.8 against 0.48),
    # which drafts with the cheap model: the tokens are the target's own
    rid = srv.submit("gamma delta epsilon", lam=0.1, max_new_tokens=8)
    out = srv.drain()
    c = srv.engine.counters()
    for key in ("spec_rounds", "spec_drafted", "spec_accepted",
                "spec_rejected"):
        assert key in c
    assert c["spec_drafted"] == c["spec_accepted"] + c["spec_rejected"] > 0
    assert c["spec_rejected"] > 0
    plain = _make_server(pool, _ecfg(True))
    prid = plain.submit("gamma delta epsilon", lam=0.1, max_new_tokens=8)
    np.testing.assert_array_equal(out[rid], plain.drain()[prid])


# ----------------------------------------- the port against the reference
@pytest.mark.parametrize("paged", [False, True])
def test_spec_engine_matches_jax_engine(paged):
    """Reduced qwen2-1.5b (target) and a one-layer drafter of the same
    vocabulary in f32, the same weights in both packages, spec_k 3, routed
    at λ 0.1 to the target by a K-means router, which pairs it with the
    drafter through ``_pick_draft`` (every other request pins the target
    as its own drafter, ``draft_model=0``): tokens and acceptance counters
    equal the JAX gateway's."""
    import dataclasses
    jt = jget_config("qwen2-1.5b").reduced()
    jd = dataclasses.replace(jt, name="qwen2-drafter", n_layers=1)
    t_cfg = get_config("qwen2-1.5b").reduced()
    d_cfg = dataclasses.replace(t_cfg, name="qwen2-drafter", n_layers=1)
    jps = [jinit_params(jax.random.PRNGKey(i), c)
           for i, c in ((0, jt), (1, jd))]
    tps = [convert.model_params_from_numpy(jax.tree.map(np.asarray, p), c,
                                           device="cpu")
           for p, c in zip(jps, (t_cfg, d_cfg))]
    state = {"centroids": np.zeros((1, 16), np.float32),
             "A": np.array([[0.9, 0.5]], np.float32),
             "C": np.array([[1.0, 0.2]], np.float32),
             "n": np.ones((1, 2), np.float32)}
    kw = dict(slots=3, max_seq=64, chunk=4, spec_k=3,
              page_size=8 if paged else None)
    jsrv = jgateway.RoutedServer(
        [jgateway.PoolModel("t", jt, jps[0], 1.0),
         jgateway.PoolModel("d", jd, jps[1], 0.2)],
        jrouters.make("kmeans", JRouterConfig(d_emb=16, num_models=2),
                      state=jax.tree.map(jnp.asarray, state)),
        engine_cfg=jengine.EngineConfig(**kw))
    tsrv = RoutedServer(
        [PoolModel("t", t_cfg, tps[0], 1.0),
         PoolModel("d", d_cfg, tps[1], 0.2)],
        routers.make("kmeans", RouterConfig(d_emb=16, num_models=2),
                     state=convert.router_state_from_numpy(state,
                                                           device="cpu")),
        engine_cfg=EngineConfig(**kw), device="cpu")
    prompts = ["write a poem about the sea", "prove it", "one two three four",
               "summarize the meeting notes carefully now please"]
    results = []
    for srv in (jsrv, tsrv):
        rids = [srv.submit(p, lam=0.1, max_new_tokens=10 + 3 * i,
                           draft_model=0 if i % 2 else None)
                for i, p in enumerate(prompts)]
        out = srv.drain()
        results.append(([np.asarray(out[r]) for r in rids],
                        srv.engine.counters()))
    (jout, jc), (tout, tc) = results
    assert tc == jc
    assert 0 < tc["spec_accepted"] < tc["spec_drafted"]
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(a, b)
