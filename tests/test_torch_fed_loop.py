"""The port's ``FedLoop`` and its checkpoint codec on the CPU, against the
JAX package.

* The codec: the port's msgpack encoder writes the bytes
  ``msgpack.packb(..., use_bin_type=True)`` writes over a grid of trees
  (every int boundary, str and bin at each length boundary, nested maps
  and lists, bf16 / f32 / i32 arrays, None and booleans), reads what
  ``msgpack.unpackb`` reads, reads every file the reference's
  ``ckpt.save`` writes, and needs no msgpack package.
* Twins of the reference's loop tests (``tests/test_fedloop.py``,
  ``tests/test_faults.py`` from the checkpoint tests on and the FedLoop
  cases of ``tests/test_engine_resilience.py``), each pinning the same
  contract in the port. Where the reference pins "zero retraces" of a hot
  swap, the port's bar is that the engine's KV pools stay the same
  storage and no kernel library is built or bound.
* Against the JAX loop, with the same pool weights and router init
  (carried by ``convert``) and the same deterministic traffic: routes, the
  harvested federated view and the pending evaluations equal before any
  sync; two syncs with ``full_batch=True`` (injected by wrapping each loop
  module's ``routers.fit_federated``, no knob of the program) agree to
  1e-5 leaf by leaf and route the same afterwards; a loop checkpoint the
  JAX package writes restores every field but the PRNG key into the port.
"""
import dataclasses
import sys
import types

import jax
import numpy as np
import pytest
import torch

msgpack = pytest.importorskip("msgpack")

from repro import routers as jrouters  # noqa: E402
from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.config import RouterConfig as JRouterConfig  # noqa: E402
from repro.fed import loop as jloop  # noqa: E402
from repro.fed.harvest import HarvestStore as JHarvestStore  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serve import gateway as jgateway  # noqa: E402
from repro.serve.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import convert, routers  # noqa: E402
from repro_torch.config import FedConfig, ModelConfig, RouterConfig  # noqa: E402
from repro_torch.fed import (BufferedAsyncAggregator, HarvestStore,  # noqa: E402
                             SecureAggAggregator)
from repro_torch.fed import loop as tloop  # noqa: E402
from repro_torch.fed.loop import (FedLoop, FedLoopConfig,  # noqa: E402
                                  personalize_client)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention, router_utility  # noqa: E402
from repro_torch.serve.engine import SHED, EngineConfig  # noqa: E402
from repro_torch.serve.gateway import PoolModel, RoutedServer  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

torch.set_num_threads(1)

TINY = dict(name="fedloop-tiny", arch_type="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=1, d_ff=64, vocab=97, head_dim=16,
            dtype="float32")
D_EMB = 8
N_CLIENTS = 3
CAP = 32
RK = dict(d_emb=D_EMB, num_models=2, hidden=(16, 16), dropout=0.0,
          k_local=3, k_global=4, mf_rank=4)
FK = dict(num_clients=N_CLIENTS, participation=1.0, batch_size=16, lr=3e-3)
RCFG, FCFG = RouterConfig(**RK), FedConfig(**FK)
ECFG = dict(slots=4, max_seq=32, chunk=4, page_size=8)
#: oversubscribed initial reservation: growth must preempt
PREEMPT_ECFG = EngineConfig(slots=3, max_seq=32, chunk=4, page_size=4,
                            pages=8, reserve="initial")
NO_SYNC = dict(sync_every=10 ** 9, rounds_per_sync=3, min_samples=1)


# ---------------------------------------------------------------- helpers

@pytest.fixture(scope="module")
def params():
    """The pool's weights: the reference's init, and the port's copy."""
    jp = jinit_params(jax.random.PRNGKey(0), JModelConfig(**TINY))
    return jp, convert.model_params_from_numpy(
        jax.tree.map(np.asarray, jp), ModelConfig(**TINY), device="cpu")


def _np(tree):
    """A state tree of either package as numpy leaves, dicts and lists."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(tree)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _trees_equal(a, b):
    a, b = _np(a), _np(b)
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def make_server(params, family="mlp", *, router=None, engine_cfg=None,
                clients=N_CLIENTS):
    tp = params[1]
    pool = [PoolModel("m0", ModelConfig(**TINY), tp, 0.1),
            PoolModel("m1", ModelConfig(**TINY), tp, 0.5)]
    if router is None:
        router = routers.make(family, RCFG).init(1, device="cpu")
    harvest = HarvestStore(D_EMB, capacity=CAP, clients=range(clients),
                           device="cpu")
    return RoutedServer(pool, router, harvest=harvest, device="cpu",
                        engine_cfg=engine_cfg or EngineConfig(**ECFG))


def _loop(srv, fcfg=FCFG, **kw):
    cfg = kw.pop("cfg", FedLoopConfig(**NO_SYNC))
    return FedLoop(srv, fcfg, gen=7, cfg=cfg, **kw)


def drive_traffic(srv, loop, n, *, seed=0, max_new=4):
    """Deterministic routed traffic (the reference test's): submit, read
    the choice, report a deterministic outcome, advance the loop one
    chunk. Returns the routes."""
    rng = np.random.default_rng(seed)
    routes = []
    for i in range(n):
        c = i % N_CLIENTS
        x = rng.normal(size=(D_EMB,)).astype(np.float32)
        rid = srv.submit("three word prompt", lam=0.5,
                         max_new_tokens=max_new, client_id=c, x=x)
        m = srv.routed_model(rid)
        routes.append(m)
        srv.report_outcome(rid, float(rng.random() < 0.4 + 0.3 * m),
                           0.1 + 0.4 * m)
        loop.step()
    loop.drain()
    return routes


def _drive_stateless(srv, loop, lo, hi):
    """Traffic where event i depends only on i — a killed run replays
    [lo, hi) identically after restore (``tests/test_faults.py``'s)."""
    routes = []
    for i in range(lo, hi):
        x = np.sin(np.arange(D_EMB, dtype=np.float32) * (i + 1))
        rid = srv.submit("three word prompt", lam=0.5, max_new_tokens=4,
                         client_id=i % N_CLIENTS, x=x)
        m = srv.routed_model(rid)
        routes.append(m)
        u = np.random.default_rng(1_000_003 * i + m).random()
        srv.report_outcome(rid, float(u < 0.4 + 0.3 * m), 0.1 + 0.4 * m)
        loop.step()
    loop.drain()
    loop.sync()
    return routes


def _storage(eng):
    return {m: [t.data_ptr() for layer in lane.pool.values()
                for t in layer.values()] for m, lane in eng._lanes.items()}


def _kernel_state():
    """What the port has built and bound: the loaded libraries and every
    wrapper's bound entry points."""
    return (dict(_build._libs), router_utility._bound.cache_info().currsize,
            decode_attention._bound.cache_info().currsize)


@pytest.fixture()
def loop_setup(params):
    srv = make_server(params)
    return srv, _loop(srv)


# ------------------------------------------------------------------ codec

_INTS = [0, 1, 31, 32, 127, 128, 255, 256, 2 ** 16 - 1, 2 ** 16,
         2 ** 32 - 1, 2 ** 32, 2 ** 63, 2 ** 64 - 1, -1, -31, -32, -33,
         -127, -128, -129, -2 ** 15, -2 ** 15 - 1, -2 ** 31, -2 ** 31 - 1,
         -2 ** 63]
_LENS = [0, 1, 31, 32, 255, 256, 2 ** 16 - 1, 2 ** 16]


def _arrays():
    g = torch.Generator().manual_seed(0)
    return {"bf16": torch.randn((3, 5), generator=g).to(torch.bfloat16),
            "f32": torch.randn((2, 3, 4), generator=g),
            "i32": torch.randint(-5, 5, (7,), generator=g,
                                 dtype=torch.int32),
            "u8": torch.arange(256, dtype=torch.uint8),
            "scalar": torch.tensor(1.5), "empty": torch.zeros((0, 3))}


CODEC_TREES = {
    "ints": _INTS,
    **{f"str_{n}": "é" * (n // 2) + "a" * (n % 2) for n in _LENS},
    **{f"ascii_{n}": "a" * n for n in _LENS},
    **{f"bin_{n}": bytes(range(256)) * (n // 256) + b"x" * (n % 256)
       for n in _LENS},
    **{f"list_{n}": list(range(n)) for n in (0, 15, 16, 2 ** 16 - 1,
                                            2 ** 16)},
    **{f"map_{n}": {f"k{i}": i for i in range(n)} for n in (0, 15, 16,
                                                            2 ** 16)},
    "nested": {"a": [{"b": [None, True, False, {}]}, [[], [[1.5]]]],
               3: {-1: "neg key"}, "t": (1, 2, (3,))},
    "scalars": [None, True, False, 0.0, -0.0, 1.5, -2.25e-300, 1e308,
                float("inf"), float("-inf"), np.float64(3.25)],
    "arrays": _arrays(),
    "arrays_in_lists": [_arrays(), (_arrays()["f32"], None)],
}


@pytest.mark.parametrize("name", sorted(CODEC_TREES))
def test_codec_bytes_equal_msgpack(name):
    """The port's encoding of a checkpoint tree is msgpack's, byte for
    byte, and each side reads the other's bytes to the same object."""
    tree = tckpt._pack(CODEC_TREES[name])
    want = msgpack.packb(tree, use_bin_type=True)
    assert tckpt.packb(tree) == want
    back = msgpack.unpackb(want, raw=False, strict_map_key=False)
    assert tckpt.unpackb(want) == back


def test_codec_reads_float32_and_refuses_what_it_does_not_write():
    assert tckpt.unpackb(b"\xca\x3f\xc0\x00\x00") == 1.5
    with pytest.raises(ValueError, match="0xc7"):
        tckpt.unpackb(b"\xc7\x01\x05\x00")        # ext: never written
    with pytest.raises(ValueError, match="extra bytes"):
        tckpt.unpackb(b"\xc0\xc0")
    with pytest.raises(OverflowError):
        tckpt.packb(2 ** 64)
    with pytest.raises(TypeError, match="float32"):
        tckpt.packb(np.float32(1.0))


def _jax_loop_file(tmp_path, params):
    """A FedLoop checkpoint written by the JAX package after one sync,
    with one evaluation still pending."""
    jsrv, jl = _jax_pair_side(params)
    _drive_stateless(jsrv, jl, 0, 9)
    jsrv.submit("three word prompt", lam=0.5, max_new_tokens=4,
                client_id=1, x=np.ones(D_EMB, np.float32))
    jsrv.drain()
    path = tmp_path / "jax_loop.ckpt"
    jl.save(path)
    return path, jsrv, jl


def test_codec_reads_every_reference_file(tmp_path, params):
    """Every file the reference's ``ckpt.save`` writes — router
    checkpoints of the four families, a bf16 tree, a FedLoop checkpoint —
    decodes to msgpack's object, restores to the reference's arrays, and
    encodes back to the same bytes."""
    jr = JRouterConfig(**{**RK, "num_models": 3})
    paths = []
    for fam in ("mlp", "mf", "elo"):
        p = tmp_path / f"{fam}.msgpack"
        jrouters.make(fam, jr).init(jax.random.PRNGKey(3)).save(p)
        paths.append(p)
    km = {"centroids": np.ones((4, D_EMB), np.float32),
          "A": np.zeros((4, 3), np.float32), "C": np.zeros((4, 3), np.float32),
          "n": np.arange(12, dtype=np.float32).reshape(4, 3)}
    p = tmp_path / "kmeans.msgpack"
    jrouters.make("kmeans", jr, state=km).save(p)
    paths.append(p)
    p = tmp_path / "bf16.msgpack"
    jckpt.save(p, {"w": jax.numpy.arange(6, dtype=jax.numpy.bfloat16),
                   "t": (1, [2.5, None]), "s": "x" * 40})
    paths.append(p)
    paths.append(_jax_loop_file(tmp_path, params)[0])
    for p in paths:
        raw = p.read_bytes()
        obj = tckpt.unpackb(raw)
        assert obj == msgpack.unpackb(raw, raw=False, strict_map_key=False)
        assert tckpt.packb(obj) == raw
        _trees_equal(tckpt.restore(p, device="cpu"), jckpt.restore(p))


def test_checkpoint_needs_no_msgpack(tmp_path, monkeypatch):
    """With msgpack unimportable, router checkpoints and a loop
    checkpoint still save and load (the GPU machine has no msgpack)."""
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack as _  # noqa: F401
    r = routers.make("mlp", RCFG).init(1, device="cpu")
    r.save(tmp_path / "r.msgpack")
    back = routers.load(tmp_path / "r.msgpack", RCFG, device="cpu")
    _trees_equal(back.state, r.state)
    tckpt.save(tmp_path / "t.ckpt", {"a": [1, (2,)], "x": _arrays()})
    got = tckpt.restore(tmp_path / "t.ckpt", device="cpu")
    assert got["a"] == [1, (2,)]
    for k, v in _arrays().items():
        assert torch.equal(got["x"][k], v)


# ------------------------------------------ sync ≡ offline fit (test_fedloop)

def test_fedloop_sync_reproduces_offline_fit(loop_setup):
    """A sync over deterministically harvested buffers is EXACTLY
    ``routers.fit_federated`` on the same stacked data, init and
    generator — with the generator given, and with the one the loop draws
    from its own stream (one 63-bit seed per sync)."""
    srv, loop = loop_setup
    drive_traffic(srv, loop, 15)
    data = srv.harvest.as_federated_data(pad_to=CAP)
    pre = routers.make("mlp", RCFG, state=srv.router.state)
    v0 = srv.router_version
    loop.sync(gen=42)
    offline, _ = routers.fit_federated(pre, data, FCFG, gen=42,
                                       rounds=loop.cfg.rounds_per_sync,
                                       device="cpu")
    _trees_equal(srv.router.state, offline.state)
    assert srv.router_version == v0 + 1
    assert loop.history[-1]["version"] == srv.router_version

    # the loop's own stream: one draw per sync, whatever the fit consumes
    stream = torch.Generator().set_state(loop._gen.get_state())
    seed = int(torch.randint(2 ** 63 - 1, (1,), generator=stream))
    pre = routers.make("mlp", RCFG, state=srv.router.state)
    loop.sync()
    offline, _ = routers.fit_federated(
        pre, data, FCFG, gen=torch.Generator().manual_seed(seed),
        rounds=loop.cfg.rounds_per_sync, device="cpu")
    _trees_equal(srv.router.state, offline.state)
    assert torch.equal(loop._gen.get_state(), stream.get_state())


def test_sync_with_aggregator_reproduces_offline(params):
    """The loop's aggregator knob reaches the fit: secure-agg syncs equal
    the offline secure-agg fit bit for bit."""
    srv = make_server(params)
    agg = SecureAggAggregator(scale=5.0)
    loop = FedLoop(srv, FCFG, gen=7, aggregator=agg,
                   cfg=FedLoopConfig(sync_every=10 ** 9, rounds_per_sync=2,
                                     min_samples=1))
    drive_traffic(srv, loop, 9)
    data = srv.harvest.as_federated_data(pad_to=CAP)
    pre = routers.make("mlp", RCFG, state=srv.router.state)
    loop.sync(gen=5)
    offline, _ = routers.fit_federated(pre, data, FCFG, gen=5, rounds=2,
                                       aggregator=agg, device="cpu")
    _trees_equal(srv.router.state, offline.state)


def test_empty_harvest_never_syncs(loop_setup):
    srv, loop = loop_setup
    assert loop.maybe_sync() is None           # min_samples gate
    with pytest.raises(ValueError, match="empty harvest"):
        loop.sync()


def test_loop_refuses_a_mesh_and_a_stream_on_another_device(params):
    srv = make_server(params)
    with pytest.raises(NotImplementedError, match="mesh"):
        FedLoop(srv, FCFG, gen=0, cfg=FedLoopConfig(mesh=object()))
    with pytest.raises(ValueError, match="HarvestStore"):
        FedLoop(RoutedServer(srv.pool, srv.router, device="cpu"), FCFG,
                gen=0)
    meta = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="CPU generator"):
        tloop._stream(meta)


# ------------------------------------------------------- hot swap, no rebuild

def _kmeans_router():
    """A pre-fitted K-means router (its init gives no state to serve)."""
    rng = np.random.default_rng(3)
    n = 24
    data = {"x": rng.normal(size=(N_CLIENTS, n, D_EMB)).astype(np.float32),
            "m": rng.integers(0, 2, size=(N_CLIENTS, n)).astype(np.int32),
            "acc": (rng.random((N_CLIENTS, n)) < 0.5).astype(np.float32),
            "cost": rng.random((N_CLIENTS, n)).astype(np.float32),
            "w": np.ones((N_CLIENTS, n), np.float32)}
    return routers.fit_federated(routers.make("kmeans", RCFG), data, FCFG,
                                 gen=2, device="cpu")[0]


@pytest.mark.parametrize("family", ["mlp", "mf", "elo", "kmeans"])
def test_hot_swap_no_rebuild_under_traffic(params, family):
    """Swapping refit router state under live traffic keeps the engine's
    KV pools the same storage and builds or binds no kernel (the port's
    bar for the reference's zero retraces), for every zoo family."""
    srv = make_server(params, family,
                      router=_kmeans_router() if family == "kmeans" else None)
    loop = FedLoop(srv, FCFG, gen=7,
                   cfg=FedLoopConfig(sync_every=10 ** 9, rounds_per_sync=2,
                                     min_samples=1))
    drive_traffic(srv, loop, 9)                # warm every lane + sync fit
    loop.sync(gen=3)                           # first fit replaces init
    drive_traffic(srv, loop, 4, seed=2)
    storage, built = _storage(srv.engine), _kernel_state()
    v0 = srv.router_version
    loop.sync(gen=4)
    drive_traffic(srv, loop, 6, seed=3)        # same buckets, new router
    loop.sync(gen=5)                           # and once more mid-stream
    drive_traffic(srv, loop, 6, seed=4)
    assert _storage(srv.engine) == storage
    assert _kernel_state() == built
    assert srv.router_version == v0 + 2


def test_swap_preserves_in_flight_decode(loop_setup):
    """A request decoding when the router is swapped finishes with the
    same tokens as without any swap."""
    srv, loop = loop_setup
    drive_traffic(srv, loop, 6)
    toks = np.arange(1, 6, dtype=np.int32)
    base_rid = srv.engine.submit(0, toks, 8)
    baseline = srv.engine.drain([base_rid])[base_rid]
    rid = srv.engine.submit(0, toks, 8)
    srv.step()                                 # half the chunks decoded
    loop.sync(gen=9)                           # swap mid-decode
    out = srv.engine.drain([rid])[rid]
    np.testing.assert_array_equal(out, baseline)


# -------------------------------------------------------------- onboarding

def test_onboard_model_mid_run(loop_setup):
    """A new PoolModel joins mid-run: head columns trained on calibration
    evals, pool extended, router expanded, and the loop keeps syncing with
    post-onboard harvest that covers the new model."""
    srv, loop = loop_setup
    drive_traffic(srv, loop, 9)
    rng = np.random.default_rng(5)
    calib = {"x": rng.normal(size=(40, D_EMB)).astype(np.float32),
             "m": np.full(40, 2, np.int32),
             "acc": (rng.random(40) < 0.8).astype(np.float32),
             "cost": np.full(40, 0.05, np.float32),
             "w": np.ones(40, np.float32)}
    pm = PoolModel("m2", ModelConfig(**TINY), srv.pool[0].params, 0.05)
    v0 = srv.router_version
    loop.onboard_model(pm, calib, gen=11, steps=5)
    assert len(srv.pool) == 3 and srv.router.num_models == 3
    assert srv.engine.pool is srv.pool         # engine sees the new model
    assert srv.router_version == v0 + 1
    x = rng.normal(size=(16, D_EMB)).astype(np.float32)
    choice = srv._route_x(x, lam=2.0)
    assert choice.shape == (16,) and choice.max() <= 2
    drive_traffic(srv, loop, 9, seed=6)
    loop.sync(gen=12)
    assert srv.router.num_models == 3


# -------------------------------------------------------- personalization

def test_personalization_composes_with_fedloop_router(loop_setup):
    """§6.4 over the runtime: mix the FedLoop-produced federated router
    with a client-local fit on that client's own EvalBuffer."""
    srv, loop = loop_setup
    drive_traffic(srv, loop, 18)
    loop.sync(gen=21)
    data_0 = srv.harvest.buffer(0).as_client_data()
    local, _ = routers.fit_local(routers.make("mlp", RCFG), data_0, FCFG,
                                 gen=22, steps=30, device="cpu")
    mixed_fn, (w_a, w_c) = personalize_client(srv.router, local, data_0)
    assert w_a.shape == (2,) and w_c.shape == (2,)
    assert bool(((w_a >= 0) & (w_a <= 1)).all())
    x = torch.as_tensor(data_0["x"][:5])
    A, C = mixed_fn(x)
    assert A.shape == (5, 2) and C.shape == (5, 2)
    Af, _ = srv.router.predict(x)
    Al, _ = local.predict(x)
    assert bool((A >= torch.minimum(Af, Al) - 1e-6).all())
    assert bool((A <= torch.maximum(Af, Al) + 1e-6).all())
    unlogged = sorted({0, 1} - set(data_0["m"][data_0["w"] > 0].tolist()))
    for m in unlogged:
        assert float(w_a[m]) == 0.0


# ------------------------------------ checkpoint / resume (test_faults.py)

def _fresh_loop(params):
    srv = make_server(params)
    return srv, _loop(srv)


def test_killed_and_restored_loop_continues_bit_identically(tmp_path,
                                                            params):
    """save() after phase 0, restore() into a fresh server, replay phase
    1: router state, version, history, harvest rings, the stream's state,
    the rid counter and the phase-1 routes all match the uninterrupted
    twin; the file is canonical msgpack."""
    srv_a, loop_a = _fresh_loop(params)
    _drive_stateless(srv_a, loop_a, 0, 9)
    routes_a = _drive_stateless(srv_a, loop_a, 9, 18)

    srv_b, loop_b = _fresh_loop(params)
    _drive_stateless(srv_b, loop_b, 0, 9)
    path = tmp_path / "loop.ckpt"
    loop_b.save(path)
    raw = path.read_bytes()
    assert msgpack.packb(msgpack.unpackb(raw, raw=False,
                                         strict_map_key=False),
                         use_bin_type=True) == raw
    del srv_b, loop_b

    srv_c, loop_c = _fresh_loop(params)
    loop_c.restore(path)
    routes_c = _drive_stateless(srv_c, loop_c, 9, 18)

    assert routes_a == routes_c
    _trees_equal(srv_a.router.state, srv_c.router.state)
    assert srv_a.router_version == srv_c.router_version
    assert loop_a._syncs == loop_c._syncs and loop_a._chunks == loop_c._chunks
    assert srv_a.engine._next_rid == srv_c.engine._next_rid
    assert torch.equal(loop_a._gen.get_state(), loop_c._gen.get_state())
    assert loop_a.history == loop_c.history
    for c in srv_a.harvest.client_ids():
        sa = srv_a.harvest.buffer(c).state()
        sc = srv_c.harvest.buffer(c).state()
        for k in sa:
            np.testing.assert_array_equal(sa[k], sc[k])


def test_checkpoint_rejects_family_mismatch_and_busy_engine(tmp_path,
                                                            params):
    srv, loop = _fresh_loop(params)
    _drive_stateless(srv, loop, 0, 3)
    path = tmp_path / "loop.ckpt"
    loop.save(path)

    srv.submit("three word prompt", lam=0.5, max_new_tokens=4,
               client_id=0, x=np.zeros(D_EMB, np.float32))
    with pytest.raises(ValueError, match="idle engine"):
        loop.save(tmp_path / "busy.ckpt")
    with pytest.raises(ValueError, match="in-flight"):
        _loop(srv).restore(path)
    srv.drain()

    srv2, loop2 = _fresh_loop(params)
    srv2.router = routers.make("mf", RouterConfig(
        d_emb=D_EMB, num_models=2, mf_rank=4)).init(2, device="cpu")
    with pytest.raises(ValueError, match="mlp.*router"):
        loop2.restore(path)


def test_pending_evals_survive_checkpoint(tmp_path, params):
    """A submitted-but-unreported evaluation is host-side state: it
    survives save/restore as numpy and still accepts its report."""
    srv, loop = _fresh_loop(params)
    rid = srv.submit("three word prompt", lam=0.5, max_new_tokens=4,
                     client_id=1, x=np.ones(D_EMB, np.float32))
    srv.drain()
    path = tmp_path / "loop.ckpt"
    loop.save(path)

    srv2, loop2 = _fresh_loop(params)
    loop2.restore(path)
    c, x, m, co = srv2._pending_evals[rid]
    want = srv._pending_evals[rid]
    assert isinstance(x, np.ndarray) and x.dtype == np.float32
    assert (c, m, co) == (want[0], want[2], want[3])
    np.testing.assert_array_equal(x, want[1])
    srv2.report_outcome(rid, 1.0, 0.25)
    assert len(srv2.harvest.buffer(1)) == 1


def test_fedloop_staleness_vector_tracks_silent_clients(params):
    """Under a BufferedAsync aggregator the loop passes per-client
    staleness: clients with fresh samples since the last sync are 0, a
    silent client's staleness grows by one per sync."""
    srv = make_server(params)
    loop = FedLoop(srv, FCFG, gen=7, aggregator=BufferedAsyncAggregator(),
                   cfg=FedLoopConfig(sync_every=10 ** 9, rounds_per_sync=2,
                                     min_samples=1))
    _drive_stateless(srv, loop, 0, 6)       # all clients fresh, sync 1
    ids = srv.harvest.client_ids()
    np.testing.assert_array_equal(loop._staleness_vector(ids),
                                  np.ones(N_CLIENTS, np.float32))
    for i in (0, 1):
        x = np.cos(np.arange(D_EMB, dtype=np.float32) * (i + 1))
        rid = srv.submit("three word prompt", lam=0.5, max_new_tokens=4,
                         client_id=i, x=x)
        srv.report_outcome(rid, 1.0, 0.1)
    srv.drain()
    np.testing.assert_array_equal(loop._staleness_vector(ids),
                                  np.array([0, 0, 1], np.float32))
    loop.sync()
    np.testing.assert_array_equal(loop._staleness_vector(ids),
                                  np.array([1, 1, 2], np.float32))
    loop.sync()
    np.testing.assert_array_equal(loop._staleness_vector(ids),
                                  np.array([2, 2, 3], np.float32))


def test_fedloop_cohort_config_forwards_to_fit(params, monkeypatch):
    """FedLoopConfig.cohort reaches the fit: a cohort-sampled sync swaps a
    valid router and is reproducible from the loop seed."""
    seen = []
    fit = tloop.routers.fit_federated

    def spy(*a, **kw):
        seen.append(kw.get("cohort"))
        return fit(*a, **kw)
    monkeypatch.setattr(tloop, "routers",
                        types.SimpleNamespace(fit_federated=spy))

    def run():
        srv, loop = _fresh_loop(params)
        loop.cfg = FedLoopConfig(sync_every=10 ** 9, rounds_per_sync=3,
                                 min_samples=1, cohort=2)
        _drive_stateless(srv, loop, 0, 9)
        return srv.router.state, loop.version
    s1, v1 = run()
    s2, v2 = run()
    _trees_equal(s1, s2)
    assert v1 == v2 == 1 and seen == [2, 2]


# ------------------------- FedLoop cases of tests/test_engine_resilience.py

def test_save_with_preempted_or_queued_requests_raises_idle_guard(
        tmp_path, params):
    """save() with preempted/queued requests in flight raises with the
    reference's message, which names them as in-flight; once drained the
    save succeeds."""
    srv = make_server(params, engine_cfg=PREEMPT_ECFG, clients=2)
    loop = FedLoop(srv, dataclasses.replace(FCFG, num_clients=2,
                                            batch_size=8), gen=7,
                   cfg=FedLoopConfig(sync_every=10 ** 9, rounds_per_sync=2,
                                     min_samples=1))
    x = np.zeros(D_EMB, np.float32)
    for i in range(3):
        srv.submit(f"prompt number {i} padded out", max_new_tokens=12,
                   client_id=i % 2, x=x)
    while srv.engine.preemptions == 0 and srv.engine.busy:
        loop.step()
    assert srv.engine.preemptions > 0
    assert srv.engine.busy
    with pytest.raises(ValueError, match="preempted-awaiting-resume"):
        loop.save(tmp_path / "ck.msgpack")
    loop.drain()
    loop.save(tmp_path / "ck.msgpack")


def test_engine_counters_threaded_into_fedloop_history(params):
    srv = make_server(params, clients=2, engine_cfg=EngineConfig(
        slots=2, max_seq=32, chunk=4, page_size=8, queue_cap=1))
    loop = FedLoop(srv, dataclasses.replace(FCFG, num_clients=2,
                                            batch_size=8), gen=7,
                   cfg=FedLoopConfig(sync_every=10 ** 9, rounds_per_sync=2,
                                     min_samples=1))
    x = np.zeros(D_EMB, np.float32)
    rids = [srv.submit(f"query {i} words here", max_new_tokens=4,
                       client_id=i % 2, x=x) for i in range(4)]
    sheds = srv.engine.sheds
    assert sheds > 0
    for r in rids:
        if srv.engine.status(r) != SHED:
            srv.report_outcome(r, 1.0, 0.1)
    loop.drain()
    loop.sync()
    eng_hist = loop.history[-1]["engine"]
    assert eng_hist["sheds"] == sheds
    assert set(eng_hist) >= {"sheds", "preemptions", "expiries", "cancels",
                             "resume_recompute_toks", "queue_depth_hw",
                             "peak_active"}


# ---------------------------------------------------- against the JAX loop

def _jax_pair_side(params, *, key=7, **cfg):
    jp = params[0]
    jcfg = JModelConfig(**TINY)
    pool = [jgateway.PoolModel("m0", jcfg, jp, 0.1),
            jgateway.PoolModel("m1", jcfg, jp, 0.5)]
    router = jrouters.make("mlp", JRouterConfig(**RK)).init(
        jax.random.PRNGKey(1))
    srv = jgateway.RoutedServer(
        pool, router, engine_cfg=JEngineConfig(**ECFG),
        harvest=JHarvestStore(D_EMB, capacity=CAP,
                              clients=range(N_CLIENTS)))
    loop = jloop.FedLoop(srv, JFedConfig(**FK), key=jax.random.PRNGKey(key),
                         cfg=jloop.FedLoopConfig(**{**NO_SYNC, **cfg}))
    return srv, loop


def _pair(params, **cfg):
    """The JAX loop and the port's over the same weights and router init."""
    jsrv, jl = _jax_pair_side(params, **cfg)
    state = convert.router_state_from_numpy(
        jax.tree.map(np.asarray, jsrv.router.state), device="cpu")
    tsrv = make_server(params, router=routers.make("mlp", RCFG,
                                                   state=state))
    return jsrv, jl, tsrv, FedLoop(tsrv, FCFG, gen=7,
                                   cfg=FedLoopConfig(**{**NO_SYNC, **cfg}))


def _same_pending(jsrv, tsrv):
    assert list(jsrv._pending_evals) == list(tsrv._pending_evals)
    for rid, (c, x, m, co) in jsrv._pending_evals.items():
        tc, tx, tm, tco = tsrv._pending_evals[rid]
        assert (c, m) == (tc, tm) and np.float32(co) == np.float32(tco)
        np.testing.assert_array_equal(np.asarray(x), tx)


def test_loop_traffic_matches_jax(params):
    """The same deterministic traffic through both loops, no sync yet:
    the same routes, the same harvested federated view bit for bit, the
    same pending evaluations and counters."""
    jsrv, jl, tsrv, tl = _pair(params)
    assert drive_traffic(jsrv, jl, 15) == drive_traffic(tsrv, tl, 15)
    want = jax.tree.map(np.asarray,
                        jsrv.harvest.as_federated_data(pad_to=CAP))
    got = tsrv.harvest.as_federated_data(pad_to=CAP)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for srv in (jsrv, tsrv):
        for i in range(3):
            srv.submit("three word prompt", lam=2.0, max_new_tokens=4,
                       client_id=i, x=np.full(D_EMB, i - 1.0, np.float32))
        srv.drain()
    _same_pending(jsrv, tsrv)
    assert jl._chunks == tl._chunks
    assert jsrv.engine._next_rid == tsrv.engine._next_rid


def _full_batch(monkeypatch, mod):
    """Make ``mod``'s syncs deterministic (full-batch local steps) by
    wrapping its ``routers.fit_federated``."""
    fit = mod.routers.fit_federated
    monkeypatch.setattr(mod, "routers", types.SimpleNamespace(
        fit_federated=lambda *a, **kw: fit(*a, full_batch=True, **kw)))


def test_two_syncs_match_jax(params, monkeypatch):
    """Two full-batch syncs in each package from the same router and
    harvest: the states agree to 1e-5 leaf by leaf after each, the losses
    to 1e-5 relative, and the routes after each swap are equal."""
    _full_batch(monkeypatch, jloop)
    _full_batch(monkeypatch, tloop)
    jsrv, jl, tsrv, tl = _pair(params)
    assert drive_traffic(jsrv, jl, 9) == drive_traffic(tsrv, tl, 9)
    for s in range(2):
        jl.sync()
        tl.sync()
        want, got = _np(jsrv.router.state), _np(tsrv.router.state)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
        np.testing.assert_allclose(tl.history[-1]["loss"],
                                   jl.history[-1]["loss"], rtol=1e-5)
        assert (drive_traffic(jsrv, jl, 6, seed=1 + s)
                == drive_traffic(tsrv, tl, 6, seed=1 + s))
    assert jsrv.router_version == tsrv.router_version == 2
    assert [h["samples"] for h in jl.history] == \
        [h["samples"] for h in tl.history]
    assert [h["engine"] for h in jl.history] == \
        [h["engine"] for h in tl.history]


def test_jax_checkpoint_restores_into_port(tmp_path, params):
    """A loop checkpoint written by the JAX package restores every field
    but the PRNG key into a fresh port loop: router state and version,
    harvest rings, staleness bookkeeping, history, pending evaluations,
    chunk and rid counters; the restored port routes as the JAX server
    does, and its stream is seeded from the key's words."""
    path, jsrv, jl = _jax_loop_file(tmp_path, params)
    tsrv, tl = _fresh_loop(params)
    tl.restore(path)
    _trees_equal(tsrv.router.state, jsrv.router.state)
    assert tsrv.router.device == torch.device("cpu")
    assert tsrv.router_version == jsrv.router_version == 1
    assert (tl._chunks, tl._syncs) == (jl._chunks, jl._syncs)
    assert tl._seen_at_sync == jl._seen_at_sync
    assert tl._fresh_at_sync == jl._fresh_at_sync
    assert len(tl.history) == len(jl.history) == 1
    for th, jh in zip(tl.history, jl.history):
        assert th == jh
    assert tsrv.engine._next_rid == jsrv.engine._next_rid
    _same_pending(jsrv, tsrv)
    for c in jsrv.harvest.client_ids():
        want = jsrv.harvest.buffer(c).state()
        got = tsrv.harvest.buffer(c).state()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    words = np.asarray(jl._key).astype(np.uint64).tolist()
    assert tl._gen.initial_seed() == (words[0] << 32) | words[1]
    xs = np.random.default_rng(9).normal(size=(8, D_EMB)).astype(np.float32)
    np.testing.assert_array_equal(tsrv._route_x(xs, 0.5),
                                  np.asarray(jsrv._route_x(xs, 0.5)))
