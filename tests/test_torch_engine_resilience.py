"""The PyTorch engine under overload, on the CPU: deadlines, cancellation,
paged-pool preemption with recompute-on-resume, load shedding, typed
terminal statuses, the PageTable release and grow guards, and the
gateway's expiry-as-backend-failure count.

Case by case the counterpart of ``tests/test_engine_resilience.py``. The
reference pins "zero decode retraces"; the port's bar is that the pool
tensors are the same storage before and after. Beyond the reference
suite: the port engine's tokens and counters equal the JAX engine's on
the same weights (carried by ``convert``) under initial reservation with
preemption, and the reference's deadline replay (``bench_preempt``'s
traffic, events from ``benchmarks/perf_suite.py::_deadline_traffic``)
gives the reference's counts in all six cells, through the copy of that
traffic and the replay loop that ``chip_smoke.py`` runs on the card.

The gateway's harvest accounting of these outcomes (the zero-score
record of an expiry, cancel and shedding dropping the registration) is
held against the reference in ``tests/test_torch_fed_gateway.py``; the
reference cases that need ``FedLoop`` are in
``tests/test_torch_fed_loop.py``, those of ``engine_chaos_schedule`` in
``tests/test_torch_fed_scenarios.py``.
"""
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the reference's benchmarks folder
    sys.path.insert(0, str(ROOT))
from benchmarks import perf_suite  # noqa: E402
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.serve import engine as jengine
from repro.serve import gateway as jgateway
from repro_torch import convert, routers
from repro_torch.config import ModelConfig, RouterConfig
from repro_torch.configs import get_config
from repro_torch.serve.engine import (CANCELLED, DONE, EXPIRED,
                                      PREEMPTED_RESUMED, SHED,
                                      TERMINAL_STATUSES, EngineConfig,
                                      Outcome, ServeEngine)
from repro_torch.serve.gateway import PoolModel, RoutedServer, make_pool_model
from repro_torch.serve.kv_cache import PageTable

torch.set_num_threads(1)

TINY = ModelConfig(name="tiny-dense-resil", arch_type="dense", n_layers=2,
                   d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=97,
                   head_dim=16)
#: oversubscribed initial-reservation shape: 3 slots but only 8 pages of
#: 4 — two long requests already exceed the pool mid-decode, so growth
#: must preempt
PREEMPT_ECFG = EngineConfig(slots=3, max_seq=32, chunk=4, page_size=4,
                            pages=8, reserve="initial")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pm():
    return make_pool_model("tiny", TINY, 0.1, gen=0, device="cpu")


def _eng(pool, ecfg):
    return ServeEngine(pool, ecfg, device="cpu")


_solo_cache = {}


def _solo(pm, toks, max_new):
    key = (pm.name, np.asarray(toks).tobytes(), max_new)
    if key not in _solo_cache:
        _solo_cache[key] = RoutedServer._serve_batch(
            pm, np.asarray(toks)[None], max_new)[0]
    return _solo_cache[key]


def _toks(seed, n):
    return np.random.default_rng(seed).integers(
        1, TINY.vocab, size=n).astype(np.int32)


def _storage(eng):
    return {m: [t.data_ptr() for layer in lane.pool.values()
                for t in layer.values()] for m, lane in eng._lanes.items()}


def _assert_pool_recovered(eng):
    """Slots, pages, queue, and carry all back to the initial state."""
    for lane in eng._lanes.values():
        assert sorted(lane.free) == list(range(eng.ecfg.slots))
        assert not lane.active and not lane.queue
        assert (lane.tok == 0).all() and (lane.pos == 0).all()
        if lane.paged:
            assert sorted(lane.pt.free) == \
                list(range(1, eng.ecfg.resolved_pages + 1))
            assert not lane.pt._held and (lane.pt.table == 0).all()
    assert not eng.busy and not eng._events


# ----------------------------------------------------- PageTable guards


def test_pagetable_release_double_release_is_deterministic_noop():
    pt = PageTable(slots=2, pages=4, page_size=4, max_seq=32)
    pt.alloc(0, 3)
    assert pt.available == 1
    assert pt.release(0) is True
    assert pt.available == 4
    assert pt.release(0) is False
    assert pt.release(0) is False
    assert sorted(pt.free) == [1, 2, 3, 4]
    assert pt.release(1) is False
    with pytest.raises(IndexError, match="outside the page table"):
        pt.release(7)


def test_pagetable_grow_guards():
    pt = PageTable(slots=2, pages=4, page_size=4, max_seq=16)  # width 4
    with pytest.raises(RuntimeError, match="holds no pages"):
        pt.grow(0, 1)
    pages = list(pt.alloc(0, 2))
    pages += list(pt.grow(0, 2))
    assert len(set(pages)) == 4 and pt.available == 0
    assert pt.held(0) == 4 and pt.held(1) == 0
    assert (pt.table[0] == pages).all()
    with pytest.raises(RuntimeError, match="wide"):
        pt.grow(0, 1)                       # past the static table width
    pt2 = PageTable(slots=2, pages=2, page_size=4, max_seq=32)
    pt2.alloc(0, 2)
    pt2._held[1] = []                       # an admitted-empty row
    with pytest.raises(RuntimeError, match="exhausted"):
        pt2.grow(0, 1)


# --------------------------------------------- cancellation & deadlines


def test_cancel_queued_and_active(pm):
    eng = _eng([pm], EngineConfig(slots=1, max_seq=32, chunk=4,
                                  page_size=8))
    t_a, t_b = _toks(0, 5), _toks(1, 4)
    ra = eng.submit(0, t_a, 12)
    rb = eng.submit(0, t_b, 4)              # waits: one slot
    eng.step()
    assert eng.status(ra) == "ACTIVE" and eng.status(rb) == "QUEUED"
    assert eng.cancel(rb) == CANCELLED
    assert eng.cancel(ra) == CANCELLED
    out = eng.drain()
    assert isinstance(out[ra], Outcome) and out[ra].status == CANCELLED
    assert out[rb].tokens is None
    np.testing.assert_array_equal(out[ra].tokens,
                                  _solo(pm, t_a, 12)[:len(out[ra].tokens)])
    assert eng.cancels == 2
    assert eng.cancel(ra) == CANCELLED
    with pytest.raises(KeyError, match="unknown request id"):
        eng.cancel(10 ** 9)
    _assert_pool_recovered(eng)


def test_deadline_expiry_releases_and_surfaces_partial_tokens(pm):
    eng = _eng([pm], EngineConfig(slots=2, max_seq=32, chunk=4,
                                  page_size=8))
    t = _toks(2, 5)
    r_exp = eng.submit(0, t, 16, deadline=2)
    r_ok = eng.submit(0, _toks(3, 4), 16)
    eng.step()
    eng.step()
    finished = dict(eng.step())             # the expiry surfaces here
    assert isinstance(finished[r_exp], Outcome)
    assert finished[r_exp].status == EXPIRED
    # deadline=2: two steps of progress, two chunks of a solo prefix
    np.testing.assert_array_equal(finished[r_exp].tokens,
                                  _solo(pm, t, 16)[:8])
    assert eng.expiries == 1
    assert eng.status(r_exp) == EXPIRED
    out = eng.drain()
    assert out[r_ok].shape == (16,)
    _assert_pool_recovered(eng)
    with pytest.raises(ValueError, match="deadline"):
        eng.submit(0, t, 4, deadline=0)


def test_queued_request_expires_without_ever_admitting(pm):
    eng = _eng([pm], EngineConfig(slots=1, max_seq=32, chunk=4,
                                  page_size=8))
    ra = eng.submit(0, _toks(4, 4), 12)
    rb = eng.submit(0, _toks(5, 4), 4, deadline=1)   # starves in queue
    out = eng.drain()
    assert out[rb].status == EXPIRED and out[rb].tokens is None
    assert out[ra].shape == (12,)
    _assert_pool_recovered(eng)


def test_drain_rids_returns_typed_terminal_instead_of_raising(pm):
    eng = _eng([pm], EngineConfig(slots=1, max_seq=32, chunk=4,
                                  page_size=8, queue_cap=1))
    ra = eng.submit(0, _toks(6, 4), 12)
    eng.step()                              # ra takes the slot
    rb = eng.submit(0, _toks(7, 4), 12, deadline=1)
    rc = eng.submit(0, _toks(8, 4), 4)      # queue full (cap 1) → shed
    assert eng.status(rc) == SHED
    eng.cancel(ra)
    got = eng.drain([ra, rb, rc])
    assert got[ra].status == CANCELLED
    assert got[rb].status == EXPIRED
    assert got[rc].status == SHED
    again = eng.drain([rc])
    assert again[rc].status == SHED
    with pytest.raises(KeyError, match="unknown request ids"):
        eng.drain([10 ** 9])
    _assert_pool_recovered(eng)


# ------------------------------------------------------- load shedding


def test_shed_reject_newest(pm):
    eng = _eng([pm], EngineConfig(slots=1, max_seq=32, chunk=4,
                                  page_size=8, queue_cap=2))
    rids = [eng.submit(0, _toks(9 + i, 4), 4) for i in range(4)]
    assert eng.status(rids[0]) == "QUEUED"
    assert [eng.status(r) for r in rids[2:]] == [SHED, SHED]
    assert eng.sheds == 2
    out = eng.drain()
    assert out[rids[0]].shape == (4,)
    assert isinstance(out[rids[2]], Outcome)
    _assert_pool_recovered(eng)


def test_shed_reject_latest_deadline_displaces_queued_victim(pm):
    eng = _eng([pm], EngineConfig(slots=1, max_seq=32, chunk=4,
                                  page_size=8, queue_cap=1,
                                  shed_policy="reject-latest-deadline"))
    r_active = eng.submit(0, _toks(20, 4), 12)
    eng.step()
    assert eng.status(r_active) == "ACTIVE"
    r_loose = eng.submit(0, _toks(21, 4), 4, deadline=50)
    r_tight = eng.submit(0, _toks(22, 4), 4, deadline=30)
    assert eng.status(r_loose) == SHED
    assert eng.status(r_tight) == "QUEUED"
    r_latest = eng.submit(0, _toks(23, 4), 4, deadline=99)
    assert eng.status(r_latest) == SHED
    r_none = eng.submit(0, _toks(24, 4), 4)
    assert eng.status(r_none) == SHED
    assert eng.sheds == 3
    out = eng.drain()
    assert out[r_tight].shape == (4,)
    _assert_pool_recovered(eng)


def test_lane_quotas_isolate_models(pm):
    eng = _eng([pm, pm], EngineConfig(slots=1, max_seq=32, chunk=4,
                                      page_size=8, lane_quotas=((0, 1),)))
    r0 = [eng.submit(0, _toks(30 + i, 4), 4) for i in range(3)]
    r1 = [eng.submit(1, _toks(40 + i, 4), 4) for i in range(3)]
    assert [eng.status(r) for r in r0[1:]] == [SHED, SHED]
    assert all(eng.status(r) == "QUEUED" for r in r1)
    out = eng.drain()
    assert all(out[r].shape == (4,) for r in r1)
    assert eng.counters()["sheds"] == 2


# ------------------------------------- preemption + recompute-on-resume


def _preempt_schedule(eng):
    reqs = [(_toks(50 + i, 5 + i), 12) for i in range(3)]
    rids = [eng.submit(0, t, m) for t, m in reqs]
    return reqs, rids, eng.drain()


def test_preempted_request_resumes_bit_identical(pm):
    """A preempted-then-resumed request's tokens are exactly its
    never-preempted solo twin's, and its status says it was preempted."""
    eng = _eng([pm], PREEMPT_ECFG)
    reqs, rids, out = _preempt_schedule(eng)
    assert eng.preemptions > 0, "schedule failed to force a preemption"
    assert eng.resume_recompute_toks > 0
    resumed = 0
    for rid, (t, m) in zip(rids, reqs):
        np.testing.assert_array_equal(out[rid], _solo(pm, t, m))
        if eng.status(rid) == PREEMPTED_RESUMED:
            resumed += 1
        else:
            assert eng.status(rid) == DONE
    assert resumed > 0
    _assert_pool_recovered(eng)


def test_admission_preemption_needs_strictly_later_deadline_victim(pm):
    ecfg = EngineConfig(slots=2, max_seq=32, chunk=4, page_size=4,
                        pages=6, reserve="initial")
    eng = _eng([pm], ecfg)
    t_bg = _toks(60, 12)                    # bucket 16 → 4 initial pages
    r_bg = eng.submit(0, t_bg, 8)
    eng.step()
    r_head = eng.submit(0, _toks(61, 12), 8)
    eng.step()
    assert eng.preemptions == 0
    assert eng.status(r_head) == "QUEUED"
    out = eng.drain()
    assert out[r_bg].shape == (8,) and out[r_head].shape == (8,)

    eng2 = _eng([pm], ecfg)
    r_bg2 = eng2.submit(0, t_bg, 8, deadline=200)
    eng2.step()
    r_head2 = eng2.submit(0, _toks(62, 12), 8, deadline=40)
    eng2.step()
    assert eng2.preemptions >= 1
    assert eng2.status(r_bg2) in ("PREEMPTED", "ACTIVE", PREEMPTED_RESUMED)
    out2 = eng2.drain()
    np.testing.assert_array_equal(out2[r_bg2], _solo(pm, t_bg, 8))
    np.testing.assert_array_equal(out2[r_head2],
                                  _solo(pm, _toks(62, 12), 8))
    _assert_pool_recovered(eng2)


def test_zero_decode_retraces_across_cancel_preempt_expiry(pm):
    """Cancellation, preemption and expiry are host bookkeeping: over a
    schedule exercising all three, and its replay on the same engine, the
    pool tensors stay the same storage and the replay gives the same
    results."""
    eng = _eng([pm], PREEMPT_ECFG)

    def schedule():
        reqs = [(_toks(70 + i, 5 + i), 12) for i in range(3)]
        rids = [eng.submit(0, t, m) for t, m in reqs]
        r_dead = eng.submit(0, _toks(75, 4), 16, deadline=3)
        eng.step()
        eng.cancel(rids[1])
        out = eng.drain()
        return [out[r] for r in (rids[0], rids[2])], out[r_dead].status

    first = schedule()
    assert eng.preemptions > 0 and eng.expiries > 0
    storage = _storage(eng)
    second = schedule()
    assert _storage(eng) == storage
    assert second[1] == EXPIRED
    for a, b in zip(first[0], second[0]):
        np.testing.assert_array_equal(a, b)
    _assert_pool_recovered(eng)


@pytest.mark.parametrize("kw, match", [
    (dict(page_size=None, reserve="initial"), "paged-pool feature"),
    (dict(reserve="eager"), "reserve"),
    (dict(shed_policy="drop-all"), "shed_policy")])
def test_reserve_initial_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        ServeEngine([], EngineConfig(**kw), device="cpu")


def test_terminal_status_vocabulary():
    assert TERMINAL_STATUSES == (DONE, PREEMPTED_RESUMED, EXPIRED,
                                 CANCELLED, SHED)
    assert PREEMPTED_RESUMED == "PREEMPTED-resumed"


def test_initial_reservation_fits_the_worst_resume_bucket(pm):
    """``fits`` under initial reservation also covers the resume bucket
    of the last chunk boundary: 9 tokens + 12 new at chunk 4 resume at
    most 9 + 8 = 17 tokens, bucket 32 > max_seq 24."""
    life = _eng([pm], EngineConfig(slots=2, max_seq=24, chunk=4,
                                   page_size=4))
    init = _eng([pm], EngineConfig(slots=2, max_seq=24, chunk=4,
                                   page_size=4, reserve="initial"))
    assert life.fits(9, 12) and not init.fits(9, 12)
    with pytest.raises(ValueError, match="max_seq=24"):
        init.submit(0, _toks(80, 9), 12)
    assert init.kv_pool_bytes() == 0
    init.submit(0, _toks(80, 4), 8)
    lane = init._lanes[0]
    assert init.kv_pool_bytes() == sum(
        t.numel() * t.element_size() for layer in lane.pool.values()
        for t in layer.values()) > 0


# ------------------------------------------------- gateway integration


def _tiny_server(ecfg):
    router = routers.make("mlp", RouterConfig(d_emb=8, num_models=1,
                                              hidden=(16,)))
    router = router.init(torch.Generator().manual_seed(1), device="cpu")
    pool = [make_pool_model("m0", TINY, 0.1, gen=0, device="cpu")]
    return RoutedServer(pool, router, engine_cfg=ecfg, device="cpu")


def test_gateway_expiry_counts_as_backend_failure():
    """An EXPIRED request counts once as a backend failure (its harvest
    record: ``tests/test_torch_fed_gateway.py``)."""
    srv = _tiny_server(EngineConfig(slots=2, max_seq=32, chunk=4,
                                    page_size=8))
    x = np.zeros(8, np.float32)
    rid = srv.submit("three word prompt", max_new_tokens=16, x=x,
                     deadline=1)
    out = srv.drain()
    assert out[rid].status == EXPIRED
    assert srv.expiry_failures == 1 and srv.backend_failures == 1
    srv.step()                              # idempotent: no double count
    assert srv.expiry_failures == 1


def test_gateway_cancel_and_shed_are_not_failures():
    srv = _tiny_server(EngineConfig(slots=1, max_seq=32, chunk=4,
                                    page_size=8, queue_cap=1))
    x = np.zeros(8, np.float32)
    r0 = srv.submit("aa bb cc", max_new_tokens=8, x=x)
    srv.step()                              # r0 takes the single slot
    r1 = srv.submit("dd ee", max_new_tokens=8, x=x)
    r2 = srv.submit("ff gg hh ii", max_new_tokens=8, x=x)
    assert srv.status(r2) == SHED
    assert srv.cancel(r1) == CANCELLED
    out = srv.drain()
    assert out[r0].shape == (8,)
    assert out[r1].status == CANCELLED and out[r2].status == SHED
    assert srv.backend_failures == 0


# ----------------------------------------- the port against the reference


def test_engine_matches_jax_engine_under_preemption():
    """Reduced qwen2-1.5b in f32 with the same weights in both packages,
    an oversubscribed initial-reservation pool, deadlines and a cancel:
    every request's result (tokens or typed outcome with its partial
    tokens), every status and every counter equal the JAX engine's."""
    arch = "qwen2-1.5b"
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jinit_params(jax.random.PRNGKey(3), jcfg)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")
    kw = dict(slots=3, max_seq=64, chunk=4, page_size=8, pages=10,
              reserve="initial")
    jeng = jengine.ServeEngine([jgateway.PoolModel(arch, jcfg, jp, 0.1)],
                               jengine.EngineConfig(**kw))
    teng = ServeEngine([PoolModel(arch, cfg, tp, 0.1)], EngineConfig(**kw),
                       device="cpu")
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32), m, d)
            for n, m, d in ((6, 16, None), (11, 20, 9), (3, 12, None),
                            (14, 16, 40), (7, 24, 3), (9, 12, None))]
    results = []
    for eng in (jeng, teng):
        rids = [eng.submit(0, t, m, deadline=d) for t, m, d in reqs[:4]]
        eng.step()
        eng.step()
        rids += [eng.submit(0, t, m, deadline=d) for t, m, d in reqs[4:]]
        eng.cancel(rids[2])
        out = eng.drain()
        results.append(([out[r] for r in rids], [eng.status(r) for r in rids],
                         eng.counters()))
    (jout, jst, jc), (tout, tst, tc) = results
    assert tc == jc and tst == jst
    assert tc["preemptions"] > 0 and tc["expiries"] > 0
    for a, b in zip(jout, tout):
        if isinstance(a, jengine.Outcome):
            assert isinstance(b, Outcome) and b.status == a.status
            a, b = a.tokens, b.tokens
            if a is None:
                assert b is None
                continue
        np.testing.assert_array_equal(np.asarray(a), b)


# --------------------------------------------- the reference's replay


#: the reference engine's counts on ``bench_preempt``'s replay (seed 0, 48
#: requests, max_new 32, chunk 8, max_seq 128, page 16, 8 slots, reduced
#: qwen2-1.5b): met_tokens, completed, expiries, sheds, preemptions,
#: resume_recompute_toks, queue_depth_hw, peak_active
REFERENCE_REPLAY = {
    ("2x", "stall"): (1440, 45, 3, 0, 0, 0, 24, 8),
    ("2x", "preempt"): (1504, 47, 1, 0, 20, 942, 21, 8),
    ("2x", "shed"): (1056, 33, 0, 15, 0, 0, 8, 8),
    ("4x", "stall"): (736, 23, 25, 0, 0, 0, 34, 5),
    ("4x", "preempt"): (1216, 38, 10, 0, 39, 1528, 31, 8),
    ("4x", "shed"): (672, 21, 2, 25, 0, 0, 8, 5)}
REPLAY_KEYS = ("met_tokens", "completed", "expiries", "sheds", "preemptions",
               "resume_recompute_toks", "queue_depth_hw", "peak_active")


@pytest.mark.parametrize("seed, n_req, long_words", [
    (0, 48, (24, 57)), (0, 16, (24, 41)), (3, 20, (24, 57))])
def test_chip_smoke_traffic_is_the_reference_traffic(seed, n_req,
                                                     long_words):
    cs = _chip_smoke()
    kw = dict(slack=2, scale=0.25, long_words=long_words)
    assert cs.deadline_traffic(seed, n_req, 32, 8, **kw) == \
        perf_suite._deadline_traffic(seed, n_req, 32, 8, **kw)
    assert cs._WORDS == perf_suite._WORDS


def test_chip_smoke_expects_the_reference_counts():
    """chip_smoke.py's expectations: BENCH_preempt.json's counts and the
    reference's two high-water marks, which are the table below."""
    cs = _chip_smoke()
    meta = json.loads((ROOT / "BENCH_preempt.json").read_text())["meta"]
    r = cs.REPLAY
    assert (r["n_req"], r["max_new"], r["chunk"], r["max_seq"],
            r["page_size"], r["slots"]) == (
        meta["n_req"], meta["max_new"], meta["chunk"], meta["max_seq"],
        meta["page_size"], meta["slots"])
    want = cs.replay_expected()
    assert {k: tuple(v[x] for x in REPLAY_KEYS) for k, v in want.items()} \
        == REFERENCE_REPLAY


@pytest.fixture(scope="module")
def replay_model():
    return make_pool_model("qwen2-1.5b", get_config("qwen2-1.5b").reduced(),
                           0.1, gen=2, device="cpu")


@pytest.mark.parametrize("cell", sorted(REFERENCE_REPLAY),
                         ids=lambda c: "-".join(c))
def test_deadline_replay_reproduces_the_reference(replay_model, cell):
    """One cell of the replay through chip_smoke.py's replay loop on the CPU:
    the reference's events, every count equal to the reference's, and in
    the preempt cells every completed request equal to its solo tokens."""
    cs = _chip_smoke()
    r = cs.REPLAY
    events = perf_suite._deadline_traffic(
        0, r["n_req"], r["max_new"], r["chunk"], slack=r["slack"],
        scale=r["scale"], long_words=r["long_words"])
    f, mode = cell
    srv = cs.replay_server(torch, "cpu", replay_model, mode, int(f[0]))
    out = cs.run_deadline_traffic(srv, events, r["max_new"])
    assert tuple(out["counts"][k] for k in REPLAY_KEYS) == \
        REFERENCE_REPLAY[cell]
    assert all(srv.engine.status(rid) in TERMINAL_STATUSES
               for rid in out["meta"])
    _assert_pool_recovered(srv.engine)
    if mode == "preempt":
        resumed = 0
        for rid, toks in out["completed"].items():
            prompt = srv._tokenize([out["meta"][rid]["prompt"]],
                                   replay_model.cfg, None)[0]
            np.testing.assert_array_equal(
                toks, _solo(replay_model, prompt, r["max_new"]))
            resumed += srv.engine.status(rid) == PREEMPTED_RESUMED
        assert resumed > 0
