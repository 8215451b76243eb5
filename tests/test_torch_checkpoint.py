"""Router checkpoints between the JAX reference and the port.

A router state saved by the reference (``Router.save``) loads into the
port (``routers.load``), saves back byte for byte and predicts what the
reference predicts; the other way round, a router fitted and saved by the
port loads into the reference, saves back byte for byte and predicts the
same. All four families are checked.
Predictions agree to 1e-5 (MLP and MF: f32 products in another order; Elo:
the f32 distance expansion and softmax over the anchors) and exactly
(K-means: the same table rows gathered at the same assignments).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("msgpack")

from repro import routers as jrouters  # noqa: E402
from repro.config import FedConfig as JFedConfig  # noqa: E402
from repro.config import RouterConfig as JRouterConfig  # noqa: E402
from repro.data.partition import federated_split  # noqa: E402
from repro.data.synthetic import make_eval_corpus  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import routers  # noqa: E402
from repro_torch.config import FedConfig, RouterConfig  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

torch.set_num_threads(1)

D_EMB = 24


@pytest.fixture(scope="module")
def data():
    corpus = make_eval_corpus(jax.random.PRNGKey(0), n_queries=600,
                              d_emb=D_EMB)
    split = federated_split(jax.random.PRNGKey(1), corpus,
                            JFedConfig(num_clients=3))
    return split, np.array(split["test_global"]["x"][:64])


def _jax_router(family):
    """A reference router with random state; the MLP state goes through
    ``jax.tree.map``, which sorts dict keys, as a fitted state's are."""
    rcfg = JRouterConfig(d_emb=D_EMB, num_models=11, hidden=(16, 16))
    if family in ("mlp", "mf"):
        r = jrouters.make(family, rcfg).init(jax.random.PRNGKey(3))
        return r.with_state(jax.tree.map(lambda a: a, r.state))
    if family == "elo":              # a cold-start prior: a fitted structure
        return jrouters.make("elo", rcfg).init(jax.random.PRNGKey(5))
    ks = jax.random.split(jax.random.PRNGKey(4), 4)
    K, M = rcfg.k_global, rcfg.num_models
    state = {"centroids": jax.random.normal(ks[0], (K, D_EMB)),
             "A": jax.random.uniform(ks[1], (K, M)),
             "C": jax.random.uniform(ks[2], (K, M)),
             "n": jnp.floor(10 * jax.random.uniform(ks[3], (K, M)))}
    return jrouters.make("kmeans", rcfg, state=state)


def _assert_same_predictions(jr, tr, x, exact):
    ja, jc = jr.predict(jnp.asarray(x))
    ta, tc = tr.predict(torch.from_numpy(x))
    tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **tol)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **tol)


@pytest.mark.parametrize("family", ["mlp", "kmeans", "mf", "elo"])
def test_reference_checkpoint_loads_and_saves_back(family, data, tmp_path):
    _, x = data
    jr = _jax_router(family)
    src, back = tmp_path / "ref.msgpack", tmp_path / "port.msgpack"
    jr.save(src)
    tr = routers.load(src, RouterConfig(d_emb=D_EMB, hidden=(16, 16)),
                      device="cpu")
    assert tr.name == family and tr.num_models == 11
    assert tr.device == torch.device("cpu")
    tr.save(back)
    assert back.read_bytes() == src.read_bytes()
    _assert_same_predictions(jr, tr, x, exact=family == "kmeans")


@pytest.mark.parametrize("family", ["mlp", "kmeans", "mf", "elo"])
def test_port_checkpoint_loads_into_the_reference(family, data, tmp_path):
    split, x = data
    rcfg = RouterConfig(d_emb=D_EMB, hidden=(16, 16))
    train = {k: np.array(v) for k, v in split["train"].items()}
    tr, _ = routers.fit_federated(routers.make(family, rcfg), train,
                                  FedConfig(num_clients=3, rounds=2), gen=4,
                                  device="cpu")
    src, back = tmp_path / "port.msgpack", tmp_path / "ref.msgpack"
    tr.save(src)
    jr = jrouters.load(src, JRouterConfig(d_emb=D_EMB, hidden=(16, 16)))
    assert jr.name == family
    jr.save(back)
    assert back.read_bytes() == src.read_bytes()
    _assert_same_predictions(jr, tr, x, exact=family == "kmeans")


def test_tree_round_trip_keeps_dtypes_lists_and_order(tmp_path):
    """bf16 through a uint16 view, int32, tuples and lists, key order:
    the reference's restore reads the port's file and writes it back
    byte for byte."""
    tree = {"z": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "a": [torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
                  (torch.zeros(0), torch.ones((2, 1)))],
            "kind": "mlp"}
    p, q = tmp_path / "t.msgpack", tmp_path / "u.msgpack"
    tckpt.save(p, tree)
    back = tckpt.restore(p, device="cpu")
    assert list(back) == ["z", "a", "kind"] and back["kind"] == "mlp"
    assert back["z"].dtype == torch.int32 and torch.equal(back["z"], tree["z"])
    assert back["a"][0].dtype == torch.bfloat16
    assert torch.equal(back["a"][0], tree["a"][0])
    assert isinstance(back["a"][1], tuple) and back["a"][1][1].shape == (2, 1)
    jckpt.save(q, jckpt.restore(p))
    assert q.read_bytes() == p.read_bytes()
