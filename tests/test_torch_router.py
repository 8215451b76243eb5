"""The PyTorch port's routing against the JAX reference on the CPU: the
encoder stub bit for bit, the MLP router's predictions to 1e-5 and its
routing decisions equal (except on rows whose top-2 utility margin is below
1e-5), on the same weights carried across by ``repro_torch.convert``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import routers as jrouters
from repro.config import RouterConfig as JRouterConfig
from repro.data.encoder import encode as jencode
from repro_torch import convert, routers
from repro_torch.config import RouterConfig
from repro_torch.core import mlp_router as R
from repro_torch.data.encoder import encode

torch.set_num_threads(1)

TEXTS = ["translate this sentence to french please",
         "prove that the sum of two even numbers is even", "", "hello",
         "Hello HELLO hello", "solve the recurrence t(n) = 2 t(n/2) + n"]


@pytest.mark.parametrize("d_emb", [16, 64, 768])
def test_encoder_matches_jax_bit_for_bit(d_emb):
    a, b = encode(TEXTS, d_emb), jencode(TEXTS, d_emb)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module", params=[(64, 5, (64, 64)), (768, 2, (512, 512))])
def routers_pair(request):
    d_emb, M, hidden = request.param
    jr = jrouters.make("mlp", JRouterConfig(d_emb=d_emb, num_models=M,
                                            hidden=hidden))
    jr = jr.init(jax.random.PRNGKey(M))
    state = convert.router_state_from_numpy(
        jax.tree.map(np.asarray, jr.state), device="cpu")
    tr = routers.make("mlp", RouterConfig(d_emb=d_emb, num_models=M,
                                          hidden=hidden), state=state)
    x = np.random.default_rng(d_emb).standard_normal((33, d_emb)).astype(
        np.float32)
    return jr, tr, x


def test_predict_matches_jax(routers_pair):
    jr, tr, x = routers_pair
    jA, jC = jr.predict(jnp.asarray(x))
    tA, tC = tr.predict(torch.from_numpy(x))
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tC.numpy(), np.asarray(jC), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("lam", [0.0, 0.5, 2.0, 10.0])
def test_route_matches_jax(routers_pair, lam):
    jr, tr, x = routers_pair
    want = np.asarray(jr.route(jnp.asarray(x), lam))
    got = tr.route(torch.from_numpy(x), lam)
    assert got.dtype == torch.int32 and got.shape == (x.shape[0],)
    jA, jC = jr.predict(jnp.asarray(x))
    U = np.asarray(jA - lam * jC)
    top2 = np.sort(U, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-5
    assert not np.any((got.numpy() != want) & ~near_tie)


def test_trunk_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form, which differs from the exact
    erf form by up to ~5e-4; the port's trunk follows the reference."""
    from repro.core import mlp_router as JR
    x = np.linspace(-4, 4, 101, dtype=np.float32)[None]
    st = {"trunk": [{"w": np.eye(101, dtype=np.float32),
                     "b": np.zeros(101, np.float32),
                     "ln_s": np.ones(101, np.float32),
                     "ln_b": np.zeros(101, np.float32)}]}
    want = np.asarray(JR.trunk_apply(jax.tree.map(jnp.asarray, st),
                                     jnp.asarray(x)))
    st_t = convert.router_state_from_numpy(st, device="cpu")
    got = R.trunk_apply(st_t, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    xn = ((x - x.mean()) / np.sqrt(x.var() + 1e-5)).astype(np.float32)
    exact = torch.nn.functional.gelu(torch.from_numpy(xn)).numpy()
    assert np.abs(exact - want).max() > 1e-4   # the test can tell them apart


def test_registry_and_init():
    rcfg = RouterConfig(d_emb=32, num_models=3, hidden=(16,))
    assert "mlp" in routers.available()
    with pytest.raises(ValueError, match="unknown router family"):
        routers.make("nope", rcfg)
    r = routers.make("mlp", rcfg)
    assert not r.initialized and r.num_models == 3
    r = r.init(torch.Generator().manual_seed(0), device="cpu")
    assert r.initialized and r.num_models == 3
    assert r.state["heads"]["acc_w"].shape == (16, 3)
    assert r.route(torch.zeros((4, 32)), 0.5).shape == (4,)
    assert r.with_state(r.state).state is r.state
