"""The PyTorch port's serving path on the CPU.

Within the port: engine tokens (paged and uniform pools, slots reused by
later requests) equal the tokens of serving each request alone on the
per-call path, exactly. Against the reference: the port's RoutedServer
routes the same prompts to the same models and emits the same greedy
tokens as the JAX RoutedServer on the same weights (reduced qwen2-1.5b and
yi-6b in f32), and the page-pool writes agree bit for bit.
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
from repro.serve import gateway as jgateway
from repro.serve import kv_cache as jkv
from repro_torch import convert, routers
from repro_torch.config import ModelConfig, RouterConfig
from repro_torch.configs import get_config
from repro_torch.serve import kv_cache as kv
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.gateway import PoolModel, RoutedServer, make_pool_model

torch.set_num_threads(1)

TINY = ModelConfig(name="tiny-dense-eng", arch_type="dense", n_layers=2,
                   d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=97,
                   head_dim=16)
PROMPTS = ["the quick brown fox", "jumps over", "a lazy dog today ok fine",
           "one two three", "counting up to five now", "zig zag",
           "when in rome do as"]


def _tiny_server(ecfg):
    router = routers.make("mlp", RouterConfig(d_emb=16, num_models=1,
                                              hidden=(8,)))
    router = router.init(torch.Generator().manual_seed(0), device="cpu")
    pool = [make_pool_model("tiny", TINY, 0.1, gen=0, device="cpu")]
    return RoutedServer(pool, router, engine_cfg=ecfg, device="cpu")


@pytest.mark.parametrize("page_size", [16, None])
def test_engine_tokens_equal_solo_tokens(page_size):
    """More requests than slots, max_new not a multiple of the chunk:
    requests join mid-flight as slots free up, and each one's tokens equal
    its single-request per-call tokens exactly."""
    srv = _tiny_server(EngineConfig(slots=2, max_seq=32, chunk=4,
                                    page_size=page_size))
    max_news = [5, 3, 8, 6, 4, 7, 5]
    rids = [srv.submit(p, lam=0.5, max_new_tokens=m)
            for p, m in zip(PROMPTS, max_news)]
    first = dict(srv.step())
    assert all(len(t) <= 4 for t in first.values())
    done = srv.drain()
    assert sorted(done) == sorted(rids)
    for p, m, rid in zip(PROMPTS, max_news, rids):
        solo = srv.generate([p], lam=0.5, max_new_tokens=m,
                            engine=False)["results"][0]["tokens"]
        assert done[rid].tolist() == solo, p
        unbucketed = srv.generate([p], lam=0.5, max_new_tokens=m,
                                  engine=False, scan_decode=False)
        assert unbucketed["results"][0]["tokens"] == solo
    assert srv.engine.n_active() == 0


def test_generate_uses_engine_and_falls_back_per_call():
    """A request whose region exceeds max_seq is served per call, with the
    same tokens it gets from the per-call path directly."""
    srv = _tiny_server(EngineConfig(slots=2, max_seq=16, chunk=4))
    long_prompt = " ".join(f"w{i}" for i in range(12))
    out = srv.generate([PROMPTS[0], long_prompt], lam=0.5, max_new_tokens=6)
    solo = [srv.generate([p], lam=0.5, max_new_tokens=6,
                         engine=False)["results"][0]["tokens"]
            for p in (PROMPTS[0], long_prompt)]
    assert [r["tokens"] for r in out["results"]] == solo
    assert out["total_cost"] == pytest.approx(0.1 * 6 * 2)


def _jax_and_port_pools():
    jpool, tpool = [], []
    for i, (arch, cost) in enumerate([("qwen2-1.5b", 0.05), ("yi-6b", 0.4)]):
        jcfg = jget_config(arch).reduced()
        jp = jinit_params(jax.random.PRNGKey(i), jcfg)
        jpool.append(jgateway.PoolModel(arch, jcfg, jp, cost))
        cfg = get_config(arch).reduced()
        tpool.append(PoolModel(arch, cfg, convert.model_params_from_numpy(
            jax.tree.map(np.asarray, jp), cfg, device="cpu"), cost))
    return jpool, tpool


SERVE_PROMPTS = ["translate this sentence to french please",
                 "prove that the sum of two even numbers is even",
                 "write a short poem about autumn leaves",
                 "derive the gradient of the loss",
                 "summarize the plot of the odyssey",
                 "solve the recurrence t of n"]


def test_routed_server_matches_jax():
    jpool, tpool = _jax_and_port_pools()
    jr = jrouters.make("mlp", JRouterConfig(d_emb=64, num_models=2,
                                            hidden=(64, 64)))
    jr = jr.init(jax.random.PRNGKey(7))
    tr = routers.make("mlp", RouterConfig(d_emb=64, num_models=2,
                                          hidden=(64, 64)),
                      state=convert.router_state_from_numpy(
                          jax.tree.map(np.asarray, jr.state), device="cpu"))
    jsrv = jgateway.RoutedServer(jpool, jr)
    tsrv = RoutedServer(tpool, tr, device="cpu")
    seen = set()
    for lam in (0.0, 2.0):
        want = jsrv.generate(SERVE_PROMPTS, lam=lam, max_new_tokens=6)
        got = tsrv.generate(SERVE_PROMPTS, lam=lam, max_new_tokens=6)
        assert got["routing"] == want["routing"]
        assert got["results"] == want["results"]
        assert got["total_cost"] == pytest.approx(want["total_cost"])
        seen.update(got["routing"])
    assert seen == {0, 1}          # both models served something


def test_page_pool_writes_match_jax():
    rng = np.random.default_rng(0)
    cfg = get_config("yi-6b").reduced()
    jcfg = jget_config("yi-6b").reduced()
    jpool = jkv.alloc_page_pool(jcfg, 6, 4)
    tpool = kv.alloc_page_pool(cfg, 6, 4, device="cpu")
    u = rng.standard_normal((2, 3, cfg.n_kv_heads, 6, cfg.head_dim)).astype(
        np.float32)
    pages = np.array([[1, 5], [2, 0], [0, 0]], np.int32)   # pad row → trash
    jout = jkv.write_prefill_pages(jpool, {"l0": {"k": jnp.asarray(u),
                                                  "v": jnp.asarray(u)}},
                                   jnp.asarray(pages))
    kv.write_prefill_pages(tpool, {"l0": {"k": torch.from_numpy(u),
                                          "v": torch.from_numpy(u)}}, pages)
    for k in ("k", "v"):
        np.testing.assert_array_equal(tpool["l0"][k][:, 1:].numpy(),
                                      np.asarray(jout["l0"][k])[:, 1:])
    ext = kv.extend_cache({"l0": {"k": torch.from_numpy(u)}}, 9)["l0"]["k"]
    jext = jkv.extend_cache({"l0": {"k": jnp.asarray(u)}}, 9)["l0"]["k"]
    np.testing.assert_array_equal(ext.numpy(), np.asarray(jext))


def test_page_table_bookkeeping():
    pt = kv.PageTable(slots=2, pages=5, page_size=4, max_seq=16)
    assert pt.max_pages == 4 and pt.available == 5
    got = pt.alloc(1, 3)
    assert got.tolist() == [1, 2, 3] and pt.table[1].tolist() == [1, 2, 3, 0]
    with pytest.raises(RuntimeError, match="exhausted"):
        pt.alloc(0, 3)
    assert pt.release(1) and not pt.release(1)
    assert pt.available == 5 and pt.table[1].tolist() == [0, 0, 0, 0]
    with pytest.raises(IndexError):
        pt.release(7)


@pytest.mark.parametrize("kw", [dict(spec_k=2), dict(reserve="initial"),
                                dict(queue_cap=4),
                                dict(lane_quotas=((0, 2),))])
def test_unported_engine_features_raise(kw):
    """Of the engine's features only the cross-silo mesh is not ported:
    each of these configurations builds an engine that serves, and raises
    only with a mesh."""
    pool = [make_pool_model("tiny", TINY, 0.1, device="cpu")]
    eng = ServeEngine(pool, EngineConfig(**kw), device="cpu")
    rid = eng.submit(0, np.arange(1, 6, dtype=np.int32), 4)
    assert eng.drain()[rid].shape == (4,)
    with pytest.raises(NotImplementedError, match="mesh"):
        ServeEngine(pool, EngineConfig(**kw), mesh=object(), device="cpu")


def test_unported_gateway_features_raise():
    srv = _tiny_server(EngineConfig(slots=2, max_seq=32, chunk=4))
    rid = srv.submit("a b c", deadline=3)
    assert srv.status(rid) == "QUEUED"
    with pytest.raises(NotImplementedError, match="mesh"):
        ServeEngine(srv.pool, mesh=object(), device="cpu")
    for kw in ("harvest", "fault_plan", "mesh"):
        with pytest.raises(NotImplementedError, match=kw):
            RoutedServer(srv.pool, srv.router, device="cpu", **{kw: object()})


def test_server_checks_devices_and_pool_size():
    srv = _tiny_server(None)
    two = routers.make("mlp", RouterConfig(d_emb=16, num_models=2,
                                           hidden=(8,))).init(0, device="cpu")
    with pytest.raises(ValueError, match="M=2"):
        RoutedServer(srv.pool, two, device="cpu")
    with pytest.raises(ValueError, match="d_emb"):
        RoutedServer(srv.pool, srv.router, d_emb=8, device="cpu")
