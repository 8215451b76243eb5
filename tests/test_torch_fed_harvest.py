"""The port's harvest store against the JAX package's on the CPU.

The same ``record`` sequence goes into both stores; the stacked federated
view (``as_federated_data``), the client ids, the LRU evictions and the
``state()`` snapshots must be equal bit for bit (numpy rings on the host
in both packages; no tolerance), and every refusal must carry the
reference's message. The port loads the reference's ``state()`` and the
reference loads the port's. A fit from the harvest equals a fit from the
same arrays bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fed.harvest import EvalBuffer as JEvalBuffer
from repro.fed.harvest import HarvestStore as JHarvestStore
from repro_torch import routers
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.fed.harvest import EvalBuffer, HarvestStore

torch.set_num_threads(1)

D_EMB, CAP = 6, 8


def _sequence(seed, n, clients):
    rng = np.random.default_rng(seed)
    return [(int(rng.choice(clients)),
             rng.standard_normal(D_EMB).astype(np.float32),
             int(rng.integers(0, 4)), float(rng.uniform()),
             float(rng.uniform(0, 2))) for _ in range(n)]


def _both(seq, **kw):
    j = JHarvestStore(D_EMB, capacity=CAP, **kw)
    t = HarvestStore(D_EMB, capacity=CAP, device="cpu", **kw)
    for rec in seq:
        j.record(*rec)
        t.record(*rec)
    return j, t


def _same_view(j, t, **kw):
    want = jax.tree.map(np.asarray, j.as_federated_data(**kw))
    got = t.as_federated_data(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device == t.device
        g = got[k].numpy()
        assert g.dtype == want[k].dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)
    return got


def _same_state(a, b):
    assert (a["d_emb"], a["capacity"]) == (b["d_emb"], b["capacity"])
    assert [c for c, _ in a["clients"]] == [c for c, _ in b["clients"]]
    for (_, sa), (_, sb) in zip(a["clients"], b["clients"]):
        assert sorted(sa) == sorted(sb)
        assert type(sa["total"]) is type(sb["total"]) is int
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])


@pytest.mark.parametrize("seed,n", [(0, 5), (1, 30), (2, 80)])
def test_federated_view_equals_reference(seed, n):
    """Rings below, at and past capacity (wraparound), one registered
    client that never records, padded and unpadded, subsets."""
    j, t = _both(_sequence(seed, n, [0, 1, 2, 5]), clients=range(4))
    assert t.client_ids() == j.client_ids() and len(t) == len(j)
    assert t.nbytes == j.nbytes
    for c in t.client_ids():
        assert t.buffer(c).total_seen == j.buffer(c).total_seen
    _same_view(j, t)
    padded = _same_view(j, t, pad_to=CAP)
    assert padded["x"].shape == (5, CAP, D_EMB)
    assert float(padded["w"][3].sum()) == 0.0      # client 3: zero weight
    _same_view(j, t, pad_to=CAP + 3, client_ids=[5, 0])
    _same_view(j, t, client_ids=[2, 3])
    _same_state(t.state(), j.state())


def test_lru_eviction_equals_reference():
    seq = _sequence(3, 60, list(range(7)))
    j, t = _both(seq, max_clients=3)
    assert t.evicted_clients == j.evicted_clients > 0
    assert t.client_ids() == j.client_ids()
    _same_view(j, t, pad_to=CAP)
    _same_state(t.state(), j.state())


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["no_clients", "all_empty", "missing",
                                  "evicted", "pad_too_small", "capacity",
                                  "max_clients", "load_shape", "ring_shape"])
def test_refusals_equal_reference(case):
    seq = _sequence(4, 20, [0, 1])

    def run(Store, Buffer, **dev):
        if case == "no_clients":
            return lambda: Store(D_EMB, capacity=CAP, **dev) \
                .as_federated_data()
        if case == "all_empty":
            s = Store(D_EMB, capacity=CAP, clients=range(3), **dev)
            return lambda: s.as_federated_data(pad_to=CAP)
        if case == "capacity":
            return lambda: Buffer(D_EMB, capacity=0)
        if case == "max_clients":
            return lambda: Store(D_EMB, max_clients=0, **dev)
        if case == "ring_shape":
            b = Buffer(D_EMB, capacity=CAP)
            return lambda: b.load_state(Buffer(D_EMB, capacity=3).state())
        s = Store(D_EMB, capacity=CAP, max_clients=2, **dev)
        for rec in seq:
            s.record(*rec)
        s.record(9, np.zeros(D_EMB), 0, 1.0, 1.0)   # evicts 0 or 1
        gone = sorted({0, 1} - set(s.client_ids()))
        return {"missing": lambda: s.as_federated_data(client_ids=[9, 4]),
                "evicted": lambda: s.as_federated_data(client_ids=gone),
                "pad_too_small": lambda: s.as_federated_data(pad_to=2),
                "load_shape": lambda: Store(D_EMB + 1, capacity=CAP,
                                            **dev).load_state(s.state()),
                }[case]

    assert _message(run(HarvestStore, EvalBuffer, device="cpu")) == \
        _message(run(JHarvestStore, JEvalBuffer))


def test_state_round_trips_and_crosses_packages():
    seq = _sequence(5, 50, [0, 1, 2, 3, 4])
    j, t = _both(seq, max_clients=4)
    back = HarvestStore(D_EMB, capacity=CAP, max_clients=4, device="cpu")
    back.load_state(t.state())
    _same_state(back.state(), t.state())
    from_ref = HarvestStore(D_EMB, capacity=CAP, max_clients=4,
                            device="cpu")
    from_ref.load_state(j.state())
    _same_view(j, from_ref, pad_to=CAP)
    to_ref = JHarvestStore(D_EMB, capacity=CAP, max_clients=4)
    to_ref.load_state(t.state())
    _same_view(to_ref, t)
    # the write heads and the LRU order survive the trip: the next
    # records land alike and evict alike (the counter is not in the state)
    before = j.evicted_clients
    for rec in _sequence(6, 12, [0, 2, 7]):
        for s in (from_ref, j):
            s.record(*rec)
    _same_view(j, from_ref, pad_to=CAP)
    assert from_ref.evicted_clients == j.evicted_clients - before > 0


@pytest.mark.parametrize("family", ["mlp", "kmeans"])
def test_fit_from_harvest_equals_fit_from_arrays(family):
    j, t = _both(_sequence(7, 90, [0, 1, 2, 3]), clients=range(4))
    arrays = jax.tree.map(np.array, j.as_federated_data(pad_to=CAP))
    rcfg = RouterConfig(d_emb=D_EMB, num_models=4, hidden=(8,), k_local=3,
                        k_global=3, kmeans_iters=3, n_init=1)
    fcfg = FedConfig(num_clients=4, participation=1.0)
    fits = [routers.fit_federated(routers.make(family, rcfg), data, fcfg,
                                  gen=3, device="cpu", rounds=2)[0]
            for data in (t.as_federated_data(pad_to=CAP), arrays)]
    a, b = (f.state for f in fits)
    flat = jax.tree.leaves(jax.tree.map(lambda x, y: torch.equal(x, y), a, b))
    assert all(flat)
