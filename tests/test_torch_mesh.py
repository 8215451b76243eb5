"""The clients mesh of the port (``sharding.py``, ``fedavg(mesh=)``,
``fed_kmeans_router_sharded``, ``launch.fed_train``) under gloo at world
sizes 1, 2 and 4, one process per rank with a ``file://`` rendezvous
under ``tmp_path`` (so test workers never share a port), each group
bounded by a timeout.

The sharded fits are held against the port's in-process fits, which
``test_torch_fit.py`` / ``test_torch_fed_fit.py`` hold against the JAX
fits: bit for bit at world 1 and for every K-means fit; at worlds 2 and 4
the MLP and MF fits train each process's clients as a smaller batched
stack, whose products may round differently in the last bit, so they are
held to 1e-6 (parameters and loss history). The deterministic
configuration at world 2 is held against the JAX in-process fit to 1e-5,
``pad_client_axis`` against the reference's exactly, and every refusal
carries the reference's message."""
import dataclasses
import multiprocessing as mp
import os
import queue
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import routers
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.core import federated as TF
from repro_torch.data.partition import federated_split
from repro_torch.data.synthetic import make_eval_corpus
from repro_torch.fed.aggregators import (BufferedAsyncAggregator,
                                         TrimmedMeanAggregator)
from repro_torch.train.optim import tree_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 8
RCFG = RouterConfig(d_emb=16, num_models=6, hidden=(16, 16), mf_rank=4,
                    k_local=4, k_global=5, kmeans_iters=5, n_init=2)
FCFG = FedConfig(num_clients=N, rounds=3, batch_size=32)
STALE = [0.0, 1.0, 2.0, 0.0, 3.0, 1.0, 0.0, 2.0]

#: name → (family, fit options, place the slab as DTensors)
FITS = {
    "default": ("mlp", {}, True),
    "cohort": ("mlp", {"cohort": 4}, True),
    "staleness": ("mlp", {"aggregator": BufferedAsyncAggregator(),
                          "staleness": STALE}, False),
    "trimmed_mean": ("mlp", {"aggregator": TrimmedMeanAggregator(
        trim_frac=0.2)}, True),
    "dp": ("mlp", {"dp_sigma": 0.05}, False),
    "mf": ("mf", {}, True),
    "kmeans": ("kmeans", {}, True),
    "kmeans_plain": ("kmeans", {}, False),
}
TIMEOUT = 120


def _split():
    g = lambda s: torch.Generator().manual_seed(s)
    corpus = make_eval_corpus(g(0), n_queries=600, n_tasks=4, n_models=6,
                              d_emb=16)
    return federated_split(g(1), corpus, FCFG)


def _fit(split, name, mesh=None):
    from repro_torch import sharding as shd
    family, kw, as_dtensor = FITS[name]
    data = split["train"]
    if mesh is not None and as_dtensor:
        data = shd.shard_clients(data, mesh)
    r, h = routers.fit_federated(routers.make(family, RCFG), data, FCFG,
                                 gen=5, device="cpu", mesh=mesh, **kw)
    return [t.numpy().copy() for t in tree_leaves(r.state)], h["loss"]


def _message(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _refusals(split, mesh) -> dict:
    from repro_torch import sharding as shd
    train = split["train"]
    seven = {k: v[:7] for k, v in train.items()}
    mlp = routers.make("mlp", RCFG)
    fit = lambda r, d, **kw: routers.fit_federated(
        r, d, FCFG, gen=0, device="cpu", rounds=1, **kw)
    out = {
        "freeze": _message(lambda: fit(mlp, train, mesh=mesh, freeze={})),
        "client_mask": _message(lambda: fit(mlp, train, mesh=mesh,
                                            client_mask=np.ones(N))),
        "n": _message(lambda: fit(mlp, seven, mesh=mesh)),
        "cohort": _message(lambda: fit(mlp, train, mesh=mesh, cohort=3)),
        "kmeans_n": _message(lambda: fit(routers.make("kmeans", RCFG),
                                         seven, mesh=mesh)),
        "kmeans_mask": _message(lambda: fit(routers.make("kmeans", RCFG),
                                            train, mesh=mesh,
                                            client_mask=np.ones(N))),
        "elo": _message(lambda: fit(routers.make("elo", RCFG), train,
                                    mesh=mesh)),
        "shard_clients": _message(lambda: shd.shard_clients(seven, mesh)),
        "not_a_mesh": _message(lambda: fit(mlp, train, mesh=object())),
    }
    return out


def _worker(rank, world, rdv, q, init):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        from repro_torch import sharding as shd
        from repro_torch.launch.op_analysis import OpCosts
        mesh = shd.client_mesh()
        split = _split()
        res = {}
        for name in FITS:
            with OpCosts() as oc:
                res[name] = _fit(split, name, mesh)
            res[name] += (oc.totals()["collectives"],)
        if init is not None:           # the deterministic fit against JAX
            from repro_torch import convert
            fcfg = FedConfig(num_clients=N, participation=1.0, lr=3e-3)
            r = routers.make("mlp", dataclasses.replace(RCFG, dropout=0.0),
                             state=convert.router_state_from_numpy(
                                 init, device="cpu"))
            fit, h = routers.fit_federated(
                r, shd.shard_clients(split["train"], mesh), fcfg, gen=7,
                device="cpu", rounds=3, full_batch=True, mesh=mesh)
            res["deterministic"] = ([t.numpy().copy()
                                     for t in tree_leaves(fit.state)],
                                    h["loss"])
        if world == 2:
            res["refusals"] = _refusals(split, mesh)
        q.put((rank, res))
    except BaseException as e:
        q.put((rank, f"{type(e).__name__}: {e}"))
        raise
    finally:
        dist.destroy_process_group()


def _run_group(world, tmp_path, init=None) -> list:
    """Start ``world`` ranks, collect their results and join them within
    TIMEOUT seconds in all, and stop every process; fails rather than
    hangs."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    rdv = tmp_path / f"rdv{world}"
    procs = [ctx.Process(target=_worker, args=(r, world, str(rdv), q, init))
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


def _fit_recording_rounds(split, name):
    """``_fit`` in process, and the global ids of each round's active
    clients (the cohort's, where one is drawn)."""
    rounds, picks = [], []
    draw_cohort, draw_active = TF._draw_cohort, TF._draw_active

    def cohort(gen, n, c):
        picks.append(draw_cohort(gen, n, c))
        return picks[-1]

    def active(*args, **kwargs):
        mask, idx = draw_active(*args, **kwargs)
        rounds.append(picks.pop()[idx] if picks else idx)
        return mask, idx

    TF._draw_cohort, TF._draw_active = cohort, active
    try:
        return (*_fit(split, name), rounds)
    finally:
        TF._draw_cohort, TF._draw_active = draw_cohort, draw_active


@pytest.fixture(scope="module")
def in_process():
    split = _split()
    return split, {name: _fit_recording_rounds(split, name)
                   for name in FITS}


def _assert_equal(got, want, exact: bool, what: str):
    (gl, gh), (wl, wh) = got[:2], want[:2]
    assert len(gl) == len(wl), what
    if exact:
        assert gh == wh, what
        for a, b in zip(gl, wl):
            assert np.array_equal(a, b), what
    else:
        np.testing.assert_allclose(gh, wh, rtol=0, atol=1e-6, err_msg=what)
        for a, b in zip(gl, wl):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=what)


def _gather_bytes(family: str, world: int, rounds: list):
    """What the fit's all-gathers move: per round, n processes × the
    largest count of active clients one process holds (blocks of N/n),
    rows of (the router's parameters, the loss, the dataset size); for
    K-means, the (centroid, size) uploads and the (K, M, 3) statistics of
    all N clients."""
    if family == "kmeans":
        kl, K, M, d = RCFG.k_local, RCFG.k_global, RCFG.num_models, 16
        return 4 * N * (kl * d + kl + K * M * 3)
    n_params = sum(t.numel() for t in tree_leaves(
        routers.make(family, RCFG).init(0, device="cpu").state))
    rows = sum(world * int(torch.bincount(ids // (N // world),
                                          minlength=world).max())
               for ids in rounds)
    return rows * (n_params + 2) * 4


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_fits_equal_in_process_fits(world, in_process, tmp_path):
    import jax
    from repro.core import federated as JF
    from repro.core import mlp_router as JR
    from repro.config import FedConfig as JFedConfig
    from repro.config import RouterConfig as JRouterConfig
    split, want = in_process
    jinit = None
    if world == 2:
        jr = JRouterConfig(**{**RCFG.__dict__, "dropout": 0.0})
        jinit = jax.tree.map(np.asarray,
                             JR.init_mlp_router(jax.random.PRNGKey(6), jr))
    ranks = _run_group(world, tmp_path, init=jinit)
    for res in ranks[1:]:          # every rank holds the replicated result
        for name in FITS:
            _assert_equal(res[name], ranks[0][name], True, name)
    got = ranks[0]
    for name, (family, kw, _) in FITS.items():
        _assert_equal(got[name], want[name],
                      world == 1 or family == "kmeans", f"{name} @ {world}")
        # the one collective of a round is the all-gather of the updates
        # (and placing the slab as DTensors, a scatter): no client's rows
        # move between processes
        coll = got[name][2]
        assert coll.get("all-gather") == _gather_bytes(
            family, world, want[name][2]), (name, coll)
        assert set(coll) <= {"all-gather", "scatter"}, (name, coll)
    if world == 2:
        train = {k: np.asarray(v) for k, v in split["train"].items()}
        jfit, jh = JF.fedavg(jax.random.PRNGKey(7), train,
                             JRouterConfig(**{**RCFG.__dict__,
                                              "dropout": 0.0}),
                             JFedConfig(num_clients=N, participation=1.0,
                                        lr=3e-3),
                             rounds=3, init=jax.tree.map(np.asarray, jinit),
                             full_batch=True)
        tl, th = got["deterministic"]
        jl = [np.asarray(a) for a in jax.tree.leaves(jfit)]
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(b).max()))
        np.testing.assert_allclose(th, np.asarray(jh["loss"]), rtol=1e-5)
        _check_refusals(got["refusals"])


def _check_refusals(msg: dict):
    """The reference's messages (``repro/core/federated.py:392-414``,
    ``repro/core/kmeans_router.py:121-125``, ``repro/routers/kmeans.py``,
    ``repro/routers/elo.py:78``, ``repro/sharding.py:191-206``)."""
    assert msg["freeze"] == (
        "ValueError: the mesh path supports only hashable knobs — freeze "
        "carry pytrees that would pin the sharded round to one fit; drop "
        "mesh= to use the in-process simulation with those")
    assert msg["client_mask"].startswith(
        "ValueError: the mesh path supports only hashable knobs — "
        "client_mask carry")
    assert msg["n"] == (
        "ValueError: N=7 stacked clients do not divide the 2-device clients "
        "mesh — pad the stack (pad_client_axis) or resize the mesh")
    assert msg["cohort"] == (
        "ValueError: cohort=3 does not divide the 2-device clients mesh — "
        "each device trains cohort/n_dev clients per round, so pick a "
        "multiple")
    assert msg["kmeans_n"] == (
        "ValueError: N=7 stacked clients do not divide the 2-device clients "
        "mesh — pad the stack (federated.pad_client_axis) or resize the "
        "mesh")
    assert msg["kmeans_mask"] == (
        "ValueError: the kmeans mesh path supports only the plain protocol "
        "— drop client_mask= or mesh=")
    assert msg["elo"].startswith("ValueError: ") and "mesh" in msg["elo"]
    assert msg["shard_clients"] == (
        "ValueError: client stack N=7 does not divide the clients mesh axis "
        "(2) — pad the stack (core.federated.pad_client_axis) or resize the "
        "mesh")
    assert msg["not_a_mesh"].startswith("TypeError: mesh= must be a "
                                        "DeviceMesh")


def test_refusal_messages_are_the_reference_text():
    """The pytree-knob refusal ``_check_refusals`` holds is the one the
    reference raises on a one-device mesh here (the others need a mesh of
    several devices; their texts are the reference's source's)."""
    import jax
    from repro import routers as jrouters
    from repro.config import FedConfig as JFedConfig
    from repro.config import RouterConfig as JRouterConfig
    jmesh = jax.make_mesh((1,), ("clients",))
    jr = jrouters.make("mlp", JRouterConfig(d_emb=4, num_models=2))
    data = {"x": np.zeros((2, 3, 4), np.float32),
            "m": np.zeros((2, 3), np.int32),
            "acc": np.zeros((2, 3), np.float32),
            "cost": np.zeros((2, 3), np.float32),
            "w": np.ones((2, 3), np.float32)}
    with pytest.raises(ValueError) as e:
        jrouters.fit_federated(jr, data, JFedConfig(num_clients=2),
                               key=jax.random.PRNGKey(0), rounds=1,
                               mesh=jmesh, freeze={})
    assert str(e.value) == (
        "the mesh path supports only hashable knobs — freeze carry pytrees "
        "that would pin the sharded round to one fit; drop mesh= to use "
        "the in-process simulation with those")


def test_pad_client_axis_equals_reference():
    import jax
    from repro.core import federated as JF
    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(5, 3, 2)).astype(np.float32),
            "m": rng.integers(0, 4, (5, 3)).astype(np.int32),
            "w": np.ones((5, 3), np.float32)}
    st = np.arange(5, dtype=np.float32)
    for mult in (1, 4, 5, 8):
        jd, js = JF.pad_client_axis(data, mult, st)
        td, ts = TF.pad_client_axis({k: torch.as_tensor(v)
                                     for k, v in data.items()}, mult,
                                    torch.as_tensor(st))
        for k in data:
            assert td[k].dtype == torch.as_tensor(np.array(jd[k])).dtype
            assert np.array_equal(td[k].numpy(), np.asarray(jd[k]))
        assert np.array_equal(np.asarray(ts), np.asarray(js))
    jd, js = JF.pad_client_axis(data, 3)
    td, ts = TF.pad_client_axis(data, 3)
    assert js is None and ts is None
    assert np.array_equal(td["x"].numpy(), np.asarray(jd["x"]))


def test_fed_train_driver_under_torch_distributed_run():
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.fed_train --device cpu`` fits through the clients
    mesh and prints, from rank 0 only, the in-process fit's losses."""
    env = {**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"}
    args = ["--clients", "4", "--rounds", "2", "--queries", "400",
            "--device", "cpu"]
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.fed_train",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT,
        env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("loss: ")]
    assert len(lines) == 2, res.stdout          # rank 0 alone printed
    assert "processes: 2, clients: 4" in res.stdout
    g = lambda s: torch.Generator().manual_seed(s)
    corpus = make_eval_corpus(g(0), n_queries=400, d_emb=64)
    fcfg = FedConfig(num_clients=4)
    split = federated_split(g(1), corpus, fcfg)
    _, h = routers.fit_federated(routers.make("mlp", RouterConfig(
        d_emb=64, num_models=11)), split["train"], fcfg, gen=2, rounds=2,
        device="cpu")
    assert lines[0] == "loss: " + " ".join(f"{v:.4f}" for v in h["loss"])
