"""The serving meshes of the port (``sharding.py``'s serving part, the
engine's and gateway's ``mesh=``, the MoE's expert-parallel dispatch and
``FedLoopConfig.mesh``) under gloo at world sizes 1, 2 and 4, one process
per rank with a ``file://`` rendezvous under a temporary directory, each
group bounded by a timeout.

* The logical-axis rules and ``kv_pool_spec`` equal the reference's on a
  table of cases (both read only the mesh's axis sizes, so the reference
  takes a stand-in mesh and needs no devices).
* Engine tokens on ``data``, ``heads`` and ``data`` × ``heads`` meshes, on
  uniform and paged lanes, plain and speculative, equal the port's solo
  engine in every rank, and so do ``counters()``. The pool holds a model
  with 2 KV heads and one with 4, so a head block is as small as one
  head and a "heads" axis that does not divide a model's heads
  replicates them; a "data" axis of 4 leaves one slot a process.
* The reference's mesh engine (``ServeEngine`` on ``data_mesh(2)``, run
  in a JAX process with 2 forced CPU devices) emits the tokens the port's
  world-2 engine emits on the same weights (carried by ``convert``).
* ``_capacity_shard_map`` on a 2×2 (``data``, ``model``) mesh: within
  1e-3 of the dense dispatch (aux 1e-4) and within 1e-5 of the JAX
  ``shard_map`` at cf 8.0 and at cf 1.25, which drops tokens; at world 1
  equal to ``_capacity_dispatch``.
* The FedLoop's mesh sync (MLP and K-means, the engine on a ``data`` mesh
  over the same group) equals the in-process loop's sync, bit for bit at
  world 1 and to 1e-6 at world 2; a loop saved at world 2 restores and
  syncs at world 1 as an in-process loop restored from the same file.
"""
import json
import multiprocessing as mp
import os
import queue
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert, routers
from repro_torch import sharding as shd
from repro_torch.config import FedConfig, ModelConfig, RouterConfig
from repro_torch.configs import get_config
from repro_torch.fed import HarvestStore
from repro_torch.fed.loop import FedLoop, FedLoopConfig
from repro_torch.models import model as mdl
from repro_torch.models import moe as tmoe
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.gateway import PoolModel, RoutedServer
from repro_torch.train.optim import tree_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120

_DENSE = dict(arch_type="dense", n_layers=2, d_model=32, d_ff=64, vocab=97,
              dtype="float32")
#: two models whose KV heads a "heads" axis of 2 splits to 1 and 2 a
#: process (one query head per KV head for the second)
KV2 = ModelConfig(name="mesh-kv2", n_heads=4, n_kv_heads=2, head_dim=8,
                  **_DENSE)
KV4 = ModelConfig(name="mesh-kv4", n_heads=4, n_kv_heads=4, head_dim=8,
                  **_DENSE)
#: the reference's TINY of tests/test_mesh.py, in f32
JTINY = dict(name="tiny-dense-mesh", n_heads=2, n_kv_heads=1, head_dim=16,
             **_DENSE)
PROMPTS = ["the quick brown fox", "jumps over", "a lazy dog today ok",
           "one two three", "counting to five now", "zig zag", "rome as"]
MAXN = [5, 3, 8, 6, 4, 7, 5]
#: λ 0.5 routes to the 2-KV-head model, λ 2 to the 4-KV-head one
LAMS = [0.5, 2.0, 0.5, 2.0, 2.0, 0.5, 2.0]
ENGINES = {
    "uniform": dict(slots=4, max_seq=64, chunk=4, page_size=None),
    "paged": dict(slots=4, max_seq=64, chunk=4, page_size=8),
    "spec uniform": dict(slots=4, max_seq=64, chunk=4, page_size=None,
                         spec_k=3),
    "spec paged": dict(slots=4, max_seq=64, chunk=4, page_size=8, spec_k=3),
}
MESHES = {
    1: {"data 1": {"data": 1}, "heads 1": {"heads": 1},
        "data x heads 1x1": {"data": 1, "heads": 1}},
    2: {"data 2": {"data": 2}, "heads 2": {"heads": 2}},
    4: {"data 4": {"data": 4}, "heads 4": {"heads": 4},
        "data x heads 2x2": {"data": 2, "heads": 2}},
}
ENGINE_CASES = [(w, m, e) for w in MESHES for m in MESHES[w]
                for e in ENGINES]

#: the reference's MoE mesh rules (tests/test_distributed.py)
MOE_RULES = {"tokens": ("data",), "experts": "model", "batch": ("data",)}
MOE_CFS = (8.0, 1.25)

#: the FedLoop cells: the reference's loop test's, with 4 clients
LOOP_TINY = ModelConfig(**JTINY)
D_EMB, N_CLIENTS, CAP = 8, 4, 32
LRCFG = RouterConfig(d_emb=D_EMB, num_models=2, hidden=(16, 16), dropout=0.0,
                     k_local=3, k_global=4)
LFCFG = FedConfig(num_clients=N_CLIENTS, participation=1.0, batch_size=16,
                  lr=3e-3)
FAMILIES = ("mlp", "kmeans")


# ---------------------------------------------------------------- serving

def _pool_params():
    return [mdl.init_params(s, c, device="cpu") for s, c in ((0, KV2),
                                                            (1, KV4))]


def _km_router(num_models, A, C):
    d = 16
    return routers.make("kmeans", RouterConfig(d_emb=d,
                                               num_models=num_models),
                        state={"centroids": torch.zeros((1, d)),
                               "A": torch.tensor([A]),
                               "C": torch.tensor([C]),
                               "n": torch.ones((1, num_models))})


def _server(ecfg: dict, mesh, params):
    pool = [PoolModel("kv2", KV2, params[0], 0.1),
            PoolModel("kv4", KV4, params[1], 0.5)]
    return RoutedServer(pool, _km_router(2, [0.9, 0.5], [0.6, 0.1]),
                        engine_cfg=EngineConfig(**ecfg), mesh=mesh,
                        device="cpu")


def _serve(srv, lams=LAMS):
    """(tokens in submit order, counters, {lane: its pool's and its
    drafters' pools' (slots or pages, KV heads)})."""
    rids = [srv.submit(p, lam=lam, max_new_tokens=m)
            for p, lam, m in zip(PROMPTS, lams, MAXN)]
    done = srv.drain()
    held = {m: [tuple(pool["l0"]["k"].shape[1:3]) for pool in
                [lane.pool] + [lane.draft_pools[d]
                               for d in sorted(lane.draft_pools)]]
            for m, lane in srv.engine._lanes.items()}
    return [done[r].tolist() for r in rids], srv.engine.counters(), held


def _jtiny_server(ecfg: dict, mesh, tree):
    cfg = ModelConfig(**JTINY)
    pool = [PoolModel("tiny", cfg, convert.model_params_from_numpy(
        tree, cfg, device="cpu"), 0.1)]
    return RoutedServer(pool, _km_router(1, [0.9], [0.1]),
                        engine_cfg=EngineConfig(**ecfg), mesh=mesh,
                        device="cpu")


#: the reference's engine twin: tests/test_mesh.py's prelude in f32
_JAX_ENGINE = """
import json
import jax, jax.numpy as jnp, numpy as np
import repro.sharding as shd
from repro import routers
from repro.config import ModelConfig, RouterConfig
from repro.models import init_params
from repro.serve import gateway
from repro.serve.engine import EngineConfig

TINY = ModelConfig(**{tiny})
router = routers.make(
    "kmeans", RouterConfig(d_emb=16, num_models=1),
    state={{"centroids": jnp.zeros((1, 16)), "A": jnp.array([[0.9]]),
           "C": jnp.array([[0.1]]), "n": jnp.ones((1, 1))}})
pool = [gateway.PoolModel("tiny", TINY,
                          init_params(jax.random.PRNGKey(0), TINY), 0.1)]
out = {{}}
for page_size in (None, 16):
    server = gateway.RoutedServer(
        pool, router, mesh=shd.data_mesh(2),
        engine_cfg=EngineConfig(slots=8, max_seq=64, chunk=4,
                                page_size=page_size))
    rids = [server.submit(p, lam=0.5, max_new_tokens=m)
            for p, m in zip({prompts}, {maxn})]
    done = server.drain()
    out[str(page_size)] = [done[r].tolist() for r in rids]
print("TOKENS " + json.dumps(out))
"""

#: the reference's MoE shard_map on a 2×2 mesh, on the inputs in {npz}
_JAX_MOE = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro import sharding as shd
from repro.models.moe import moe_forward

cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
z = np.load({npz!r})
p = {{k: jnp.asarray(z[k]) for k in ("router", "wg", "wu", "wd")}}
x = jnp.asarray(z["x"])
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
out = {{}}
for cf in {cfs}:
    with mesh, shd.use_rules(mesh, {rules}):
        y, aux = jax.jit(lambda p, x: moe_forward(
            p, x, cfg, mode="capacity", capacity_factor=cf))(p, x)
    out[f"y{{cf}}"] = np.asarray(y)
    out[f"aux{{cf}}"] = np.asarray(aux)
np.savez({out!r}, **out)
print("MOE_OK")
"""


def _jax_process(code: str, devices: int) -> subprocess.Popen:
    """A JAX process on ``devices`` forced CPU devices (XLA_FLAGS must be
    set before jax initializes, so never in this process)."""
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _jax_output(proc: subprocess.Popen) -> str:
    out, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, (out[-1000:], err[-3000:])
    return out


# ------------------------------------------------------------------- MoE

def _moe_cfg():
    return get_config("phi3.5-moe-42b-a6.6b").reduced()


def _moe_inputs(z) -> tuple:
    p = {k: torch.from_numpy(z[k]) for k in ("router", "wg", "wu", "wd")}
    return p, torch.from_numpy(z["x"])


def _moe_on_mesh(z, mesh, rules=MOE_RULES) -> dict:
    cfg = _moe_cfg()
    p, x = _moe_inputs(z)
    out = {}
    with shd.use_rules(mesh, rules):
        for cf in MOE_CFS:
            y, aux = tmoe.moe_forward(p, x, cfg, mode="capacity",
                                      capacity_factor=cf)
            out[cf] = (y.numpy(), float(aux))
    return out


# ------------------------------------------------------------------ loop

def _kmeans_router():
    """A pre-fitted K-means router (its init gives no state to serve)."""
    rng = np.random.default_rng(3)
    n = 24
    data = {"x": rng.normal(size=(N_CLIENTS, n, D_EMB)).astype(np.float32),
            "m": rng.integers(0, 2, size=(N_CLIENTS, n)).astype(np.int32),
            "acc": (rng.random((N_CLIENTS, n)) < 0.5).astype(np.float32),
            "cost": rng.random((N_CLIENTS, n)).astype(np.float32),
            "w": np.ones((N_CLIENTS, n), np.float32)}
    return routers.fit_federated(routers.make("kmeans", LRCFG), data, LFCFG,
                                 gen=2, device="cpu")[0]


def _loop(family: str, mesh=None, engine_mesh=None):
    params = mdl.init_params(0, LOOP_TINY, device="cpu")
    pool = [PoolModel("m0", LOOP_TINY, params, 0.1),
            PoolModel("m1", LOOP_TINY, params, 0.5)]
    router = (routers.make("mlp", LRCFG).init(1, device="cpu")
              if family == "mlp" else _kmeans_router())
    srv = RoutedServer(pool, router, device="cpu", mesh=engine_mesh,
                       harvest=HarvestStore(D_EMB, capacity=CAP,
                                            clients=range(N_CLIENTS),
                                            device="cpu"),
                       engine_cfg=EngineConfig(slots=4, max_seq=32, chunk=4,
                                               page_size=8))
    return srv, FedLoop(srv, LFCFG, gen=7, cfg=FedLoopConfig(
        sync_every=10 ** 9, rounds_per_sync=2, min_samples=1, mesh=mesh))


def _drive(srv, loop, n: int, seed: int = 0) -> None:
    """The reference loop test's deterministic traffic."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        x = rng.normal(size=(D_EMB,)).astype(np.float32)
        rid = srv.submit("three word prompt", lam=0.5, max_new_tokens=4,
                         client_id=i % N_CLIENTS, x=x)
        m = srv.routed_model(rid)
        srv.report_outcome(rid, float(rng.random() < 0.4 + 0.3 * m),
                           0.1 + 0.4 * m)
        loop.step()
    loop.drain()


def _state(srv) -> list:
    return [t.numpy().copy() for t in tree_leaves(srv.router.state)]


def _loop_run(family: str, mesh=None, engine_mesh=None, save=None) -> dict:
    srv, loop = _loop(family, mesh, engine_mesh)
    _drive(srv, loop, 9)
    hist = loop.sync()
    out = {"state": _state(srv), "loss": list(hist["loss"]),
           "counters": srv.engine.counters()}
    if save is not None:
        loop.save(save)
    return out


def _loop_restored(path, mesh=None, engine_mesh=None) -> dict:
    srv, loop = _loop("mlp", mesh, engine_mesh)
    loop.restore(path)
    restored = _state(srv)
    _drive(srv, loop, 3, seed=1)
    loop.sync()
    return {"restored": restored, "state": _state(srv),
            "version": srv.router_version}


# --------------------------------------------------------------- workers

def _placements(world: int) -> dict:
    """replicate, shard_leading, shard_kv_pool and constrain on a data
    mesh of ``world`` processes."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    rank = dist.get_rank()
    mesh = shd.data_mesh()
    t = torch.arange(6, dtype=torch.float32) + 10 * rank
    shd.replicate({"a": [t]}, mesh)
    lead = shd.shard_leading({"even": torch.arange(8.0),
                              "odd": torch.arange(3.0)}, mesh, "data")
    full = torch.arange(2 * 4 * 2 * 3 * 2, dtype=torch.float32).reshape(
        2, 4, 2, 3, 2)
    local = shd.shard_kv_pool({"l0": {"k": full}}, mesh)["l0"]["k"]
    x = distribute_tensor(torch.arange(8.0).reshape(4, 2), mesh,
                          [Replicate()])
    with shd.use_rules(mesh, shd.ENGINE_RULES):
        y = shd.constrain(x, ("batch", None))
        plain = torch.ones(4, 2)
        same = shd.constrain(plain, ("batch", None)) is plain
    return {"replicated": t.tolist(),
            "lead": {k: (v.placements[0] == Shard(0), v.to_local().tolist())
                     for k, v in lead.items()},
            "kv_local": local.tolist(),
            "kv_contiguous": local.is_contiguous(),
            "constrain": (y.placements[0] == Shard(0),
                          y.full_tensor().tolist()),
            "plain_passes": same}


def _chunk_gather_bytes() -> dict:
    """The collectives of one engine step on a uniform data-mesh lane:
    one all-gather of the chunk's tokens."""
    from repro_torch.launch.op_analysis import OpCosts
    params = _pool_params()
    srv = _server(ENGINES["uniform"], shd.data_mesh(), params)
    srv.submit(PROMPTS[0], lam=0.5, max_new_tokens=8)
    srv.step()                   # admission, lane creation, first chunk
    with OpCosts() as oc:
        srv.step()
    srv.drain()
    return oc.totals()["collectives"]


def _worker(rank, world, rdv, q, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        res = {}
        params = _pool_params()
        for mname, shape in MESHES[world].items():
            mesh = shd.make_mesh(shape)
            for ename, ecfg in ENGINES.items():
                res[(mname, ename)] = _serve(_server(ecfg, mesh, params))
        if world in (1, 4):
            side = 2 if world == 4 else 1
            res["moe"] = _moe_on_mesh(np.load(args["moe"]), shd.make_mesh(
                {"data": side, "model": side}))
        if world == 4:
            # tokens over two mesh axes, as the reference's multi-pod rules
            # put them ("pod", "data"): the same blocks as "data" 2
            res["moe_pod"] = _moe_on_mesh(
                np.load(args["moe"]),
                shd.make_mesh({"pod": 2, "data": 1, "model": 2}),
                {"tokens": ("pod", "data"), "experts": "model"})
        if world in (1, 2):
            for fam in FAMILIES:
                res[("loop", fam)] = _loop_run(
                    fam, shd.client_mesh(), shd.data_mesh(),
                    save=args["ckpt"] if world == 2 and fam == "mlp"
                    else None)
        if world == 1:
            res["restored"] = _loop_restored(args["ckpt"], shd.client_mesh(),
                                             shd.data_mesh())
        if world == 2:
            res["jax_twin"] = {
                str(ps): _serve(_jtiny_server(
                    dict(slots=8, max_seq=64, chunk=4, page_size=ps),
                    shd.data_mesh(), args["jtiny"]), [0.5] * len(PROMPTS))[0]
                for ps in (None, 16)}
            res["placements"] = _placements(world)
            res["gather"] = _chunk_gather_bytes()
        q.put((rank, res))
    except BaseException as e:
        q.put((rank, f"{type(e).__name__}: {e}"))
        raise
    finally:
        dist.destroy_process_group()


def _run_group(world, tmp, args) -> list:
    """Start ``world`` ranks, collect their results and join them within
    TIMEOUT seconds in all, and stop every process; fails rather than
    hangs."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    rdv = Path(tmp) / f"rdv{world}"
    procs = [ctx.Process(target=_worker, args=(r, world, str(rdv), q, args))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + TIMEOUT
    left = lambda: max(0.1, deadline - time.monotonic())
    try:
        for _ in range(world):
            rank, res = q.get(timeout=left())
            assert not isinstance(res, str), f"rank {rank}: {res}"
            got[rank] = res
        for p in procs:
            p.join(timeout=left())
            assert p.exitcode == 0, p.exitcode
    except queue.Empty:
        pytest.fail(f"world {world}: no result within {TIMEOUT} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


@pytest.fixture(scope="module")
def groups():
    """Every group's results: world 2 first (it writes the loop checkpoint
    that world 1 restores), then 4 and 1; the two JAX processes run
    beside them. Also the inputs and the JAX outputs."""
    import jax
    from repro.config import ModelConfig as JModelConfig
    from repro.models import init_params as jinit_params
    from repro.models.moe import init_moe as jinit_moe
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    jtree = jax.tree.map(np.asarray, jinit_params(
        jax.random.PRNGKey(0), JModelConfig(**JTINY)))
    from repro.configs import get_config as jget_config
    mp_ = jax.tree.map(np.asarray, jinit_moe(
        jax.random.PRNGKey(0), jget_config("phi3.5-moe-42b-a6.6b").reduced()))
    # a component shared by every token skews the routing, so that some
    # experts overflow at cf 1.25 (T_loc 32 tokens, capacity 20 a block)
    rng = np.random.default_rng(1)
    d_model = _moe_cfg().d_model
    x = (rng.normal(size=(4, 16, d_model))
         + rng.normal(size=(1, 1, d_model))).astype(np.float32)
    np.savez(d / "moe_in.npz", x=x, **mp_)
    jeng = _jax_process(_JAX_ENGINE.format(
        tiny=repr(JTINY), prompts=repr(PROMPTS), maxn=repr(MAXN)), 2)
    jmoe = _jax_process(_JAX_MOE.format(
        npz=str(d / "moe_in.npz"), cfs=repr(MOE_CFS), rules=repr(MOE_RULES),
        out=str(d / "moe_out.npz")), 4)
    try:
        args = {"moe": str(d / "moe_in.npz"), "ckpt": str(d / "loop.ckpt"),
                "jtiny": jtree}
        res = {w: _run_group(w, d, args) for w in (2, 4, 1)}
        line = next(ln for ln in _jax_output(jeng).splitlines()
                    if ln.startswith("TOKENS "))
        res["jax_engine"] = json.loads(line[len("TOKENS "):])
        assert "MOE_OK" in _jax_output(jmoe)
        res["jax_moe"] = dict(np.load(d / "moe_out.npz"))
        res["moe_in"] = dict(np.load(d / "moe_in.npz"))
        # the in-process loop restored from the world-2 file
        res["restored_in_process"] = _loop_restored(d / "loop.ckpt")
        yield res
    finally:
        for p in (jeng, jmoe):
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.cleanup()


@pytest.fixture(scope="module")
def solo():
    params = _pool_params()
    return {e: _serve(_server(ecfg, None, params))
            for e, ecfg in ENGINES.items()}


# ------------------------------------------------------------------ rules

class _Mesh:
    """A stand-in mesh: the axis sizes are all either rule set reads."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)


_RULES = {"heads": "heads", "heads4d": "heads", "batch": "data",
          "kv_seq": "data", "experts": ("data", "heads"), "absent": "pod",
          "vocab": None}
_SPEC_CASES = [
    ({"data": 2, "heads": 4}, ("batch", "seq", "heads"), (8, 5, 12)),
    ({"data": 2, "heads": 4}, ("batch", None, "heads"), (3, 5, 6)),
    ({"data": 2, "heads": 4}, ("batch", "heads4d!", None, None), (4, 6, 3, 2)),
    ({"data": 2, "heads": 4}, ("batch", "heads4d", None, None), (4, 6, 3, 2)),
    ({"data": 2, "heads": 4}, ("absent", "batch", "vocab"), (4, 4, 4)),
    ({"data": 2, "heads": 4}, ("experts", None), (16, 3)),
    ({"data": 2, "heads": 4}, ("experts", None), (12, 3)),
    ({"data": 2, "heads": 4}, ("batch", None, "heads", "kv_seq", None),
     (2, 4, 8, 6, 2)),
    ({"data": 4}, ("batch", "heads", "heads4d!"), (8, 8, 2)),
    ({"clients": 4}, ("batch", "heads"), (8, 8)),
]
_POOL_CASES = [
    ({"data": 2, "heads": 4}, 5, (2, 8, 4, 16, 8)),
    ({"data": 2, "heads": 4}, 5, (2, 129, 4, 16, 8)),
    ({"data": 2, "heads": 4}, 5, (2, 8, 2, 16, 8)),
    ({"data": 2, "heads": 4}, 4, (2, 8, 4, 3)),
    ({"data": 2, "heads": 4}, 2, (3, 6)),
    ({"data": 2, "heads": 4}, 5, None),
    ({"heads": 2}, 5, (2, 8, 4, 16, 8)),
    ({"clients": 4}, 5, (2, 8, 4, 16, 8)),
]


@pytest.mark.parametrize("axes,logical,shape", _SPEC_CASES)
def test_resolve_spec_equals_reference(axes, logical, shape):
    import repro.sharding as jshd
    mesh = _Mesh(axes)
    assert shd.resolve_spec(logical, shape) is None
    with jshd.use_rules(mesh, _RULES):
        want = tuple(jshd.resolve_spec(logical, shape))
    with shd.use_rules(mesh, _RULES):
        assert shd.active()
        got = shd.resolve_spec(logical, shape)
    assert not shd.active()
    assert got == want


@pytest.mark.parametrize("axes,ndim,shape", _POOL_CASES)
def test_kv_pool_spec_equals_reference(axes, ndim, shape):
    import repro.sharding as jshd
    mesh = _Mesh(axes)
    want = tuple(jshd.kv_pool_spec(ndim, mesh, shape))
    assert shd.kv_pool_spec(ndim, mesh, shape) == want


def test_constrain_is_the_identity_outside_rules_and_on_plain_tensors():
    x = torch.ones(4, 2)
    assert shd.constrain(x, ("batch", None)) is x
    with shd.use_rules(_Mesh({"data": 2}), shd.ENGINE_RULES):
        assert shd.constrain(x, ("batch", None)) is x
    assert shd.ENGINE_RULES == {"heads": "heads", "heads4d": "heads",
                                "batch": "data"}


def test_refusals_carry_the_reference_text():
    """``mesh=`` without a "data" or "heads" dimension raises the
    reference's ValueError (its text for a clients mesh, the reference
    given a stand-in with the same axes); a non-mesh raises TypeError, a
    mesh of another device type ValueError; the MoE shard map outside
    ``use_rules`` raises TypeError, as the reference's does; the loop
    takes only a clients mesh."""
    from repro.serve.engine import ServeEngine as JServeEngine
    params = _pool_params()
    pool = [PoolModel("kv2", KV2, params[0], 0.1)]
    with pytest.raises(ValueError) as want:
        JServeEngine([], mesh=_Mesh({"clients": 2}))
    clients = types.SimpleNamespace(mesh_dim_names=("clients",),
                                    device_type="cpu")
    with pytest.raises(ValueError) as got:
        ServeEngine(pool, mesh=clients, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        RoutedServer(pool, _km_router(1, [0.9], [0.1]), device="cpu",
                     mesh=clients)
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="DeviceMesh with a \"data\""):
        ServeEngine(pool, mesh=object(), device="cpu")
    cuda = types.SimpleNamespace(mesh_dim_names=("data",), device_type="cuda")
    with pytest.raises(ValueError, match="over cuda devices"):
        ServeEngine(pool, mesh=cuda, device="cpu")
    cfg = _moe_cfg()
    p = mdl.init_params(0, cfg, device="cpu")["blocks"]["l0"]["ffn"]
    with pytest.raises(TypeError):
        tmoe._capacity_shard_map(p, torch.zeros((2, cfg.d_model)), cfg, 1.25)
    srv, _ = _loop("mlp")
    with pytest.raises(TypeError, match="'clients' dimension"):
        FedLoop(srv, LFCFG, gen=0, cfg=FedLoopConfig(mesh=object()))


def test_moe_shard_map_outside_rules_raises_as_the_reference():
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import moe as jmoe
    from repro.models.moe import init_moe as jinit_moe
    import jax
    jcfg = jget_config("phi3.5-moe-42b-a6.6b").reduced()
    jp = jinit_moe(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(TypeError):
        jmoe._capacity_shard_map(jp, jnp.zeros((2, jcfg.d_model)), jcfg, 1.25)
    cfg = _moe_cfg()
    p = mdl.init_params(0, cfg, device="cpu")["blocks"]["l0"]["ffn"]
    with pytest.raises(TypeError, match="use_rules"):
        tmoe._capacity_shard_map(p, torch.zeros((2, cfg.d_model)), cfg, 1.25)


# ----------------------------------------------------------------- engine

@pytest.mark.parametrize("world,mesh,engine", ENGINE_CASES)
def test_engine_tokens_and_counters_equal_solo(groups, solo, world, mesh,
                                               engine):
    want = solo[engine]
    axes = MESHES[world][mesh]
    for rank, res in enumerate(groups[world]):
        toks, counters, held = res[(mesh, engine)]
        assert toks == want[0], (rank, mesh, engine)
        assert counters == want[1], (rank, mesh, engine)
        # each process holds its block: slots over "data" (a page pool
        # keeps its pages), KV heads over "heads" where they divide
        for m, shapes in want[2].items():
            for i, (rows, hkv) in enumerate(shapes):
                paged = i == 0 and ENGINES[engine]["page_size"]
                rows //= 1 if paged else axes.get("data", 1)
                k = axes.get("heads", 1)
                hkv //= k if hkv % k == 0 else 1
                assert held[m][i] == (rows, hkv), (rank, mesh, engine, m)
    if engine.startswith("spec"):
        assert want[1]["spec_rounds"] > 0


@pytest.mark.parametrize("page_size", ["None", "16"])
def test_world2_data_engine_equals_the_reference_mesh_engine(groups,
                                                             page_size):
    want = groups["jax_engine"][page_size]
    for res in groups[2]:
        assert res["jax_twin"][page_size] == want


def test_one_all_gather_of_the_chunk_tokens_per_step(groups):
    """A data-mesh lane's step moves slots · (chunk + 1) int32 tokens by
    one all-gather, and nothing else."""
    ecfg = ENGINES["uniform"]
    for res in groups[2]:
        assert res["gather"] == {
            "all-gather": ecfg["slots"] * (ecfg["chunk"] + 1) * 4}


def test_placement_helpers(groups):
    full = np.arange(2 * 4 * 2 * 3 * 2, dtype=np.float32).reshape(
        2, 4, 2, 3, 2)
    for rank, res in enumerate(groups[2]):
        pl = res["placements"]
        assert pl["replicated"] == [float(v) for v in range(6)]
        assert pl["lead"]["even"] == (True, [4.0 * rank + i
                                             for i in range(4)])
        assert pl["lead"]["odd"] == (False, [0.0, 1.0, 2.0])
        assert pl["kv_local"] == full[:, 2 * rank:2 * rank + 2].tolist()
        assert pl["kv_contiguous"]
        assert pl["constrain"] == (True, np.arange(8.0).reshape(4, 2)
                                   .tolist())
        assert pl["plain_passes"]


# -------------------------------------------------------------------- MoE

@pytest.mark.parametrize("cf", MOE_CFS)
def test_moe_shard_map_equals_jax_and_dense(groups, cf):
    z = groups["moe_in"]
    cfg = _moe_cfg()
    p, x = _moe_inputs(z)
    dense, aux_d = tmoe.moe_forward(p, x, cfg, mode="dense")
    jy, jaux = groups["jax_moe"][f"y{cf}"], groups["jax_moe"][f"aux{cf}"]
    for res in groups[4]:
        y, aux = res["moe"][cf]
        np.testing.assert_allclose(y, jy, rtol=0, atol=1e-5)
        assert abs(aux - float(jaux)) <= 1e-5
        if cf == 8.0:
            assert np.abs(y - dense.numpy()).max() < 1e-3
            assert abs(aux - float(aux_d)) < 1e-4
        else:               # cf 1.25 drops tokens: not the dense result
            assert np.abs(y - dense.numpy()).max() > 1e-3


def test_moe_shard_map_over_two_token_axes(groups):
    for res in groups[4]:
        for cf in MOE_CFS:
            y, aux = res["moe_pod"][cf]
            assert np.array_equal(y, res["moe"][cf][0])
            assert aux == res["moe"][cf][1]


def test_moe_shard_map_at_world1_equals_capacity_dispatch(groups):
    cfg = _moe_cfg()
    p, x = _moe_inputs(groups["moe_in"])
    for cf in MOE_CFS:
        want, aux = tmoe.moe_forward(p, x, cfg, mode="capacity",
                                     capacity_factor=cf)
        y, got_aux = groups[1][0]["moe"][cf]
        assert np.array_equal(y, want.numpy())
        assert got_aux == float(aux)


# ------------------------------------------------------------------- loop

@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_fedloop_mesh_sync_equals_in_process_sync(groups, world, family):
    want = _loop_run(family)
    for res in groups[world]:
        got = res[("loop", family)]
        assert got["counters"] == want["counters"]
        assert len(got["state"]) == len(want["state"])
        if world == 1 or family == "kmeans":
            assert got["loss"] == want["loss"]
            for a, b in zip(got["state"], want["state"]):
                assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                       atol=1e-6)
            for a, b in zip(got["state"], want["state"]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_fedloop_saved_at_world2_restores_and_syncs_at_world1(groups):
    saved = groups[2][0][("loop", "mlp")]["state"]
    want = groups["restored_in_process"]
    got = groups[1][0]["restored"]
    for a, b in zip(got["restored"], saved):
        assert np.array_equal(a, b)
    for a, b in zip(want["restored"], saved):
        assert np.array_equal(a, b)
    assert got["version"] == want["version"]
    for a, b in zip(got["state"], want["state"]):
        assert np.array_equal(a, b)
