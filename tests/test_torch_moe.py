"""The PyTorch port's MoE layer (``repro_torch.models.moe``) against the JAX
reference (``repro.models.moe``) on the CPU.

Reduced f32 configs of the three MoE archs (phi-3.5-MoE, kimi-k2, jamba's
MoE layers), weights from the reference's ``init_moe`` and token
activations drawn with numpy from a seed, fed to both. Top-k ids are held
exactly (ties included: the lower expert id first, as ``jax.lax.top_k``
orders them), f32 values to 1e-5 relative (plus 1e-6 of the largest
magnitude, for entries that cancel to near zero).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"]


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """(JAX cfg, port cfg, JAX params, port params) of one MoE layer."""
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = jmoe.init_moe(jax.random.PRNGKey(11), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def test_params_have_the_reference_shapes_and_dtypes(layer):
    jcfg, cfg, jp, _ = layer
    own = tmoe.init_moe(torch.Generator().manual_seed(0), cfg)
    assert sorted(own) == sorted(jp)
    for k, v in own.items():
        assert tuple(v.shape) == jp[k].shape
        assert str(v.dtype) == "torch." + str(jp[k].dtype)
    assert own["router"].dtype == torch.float32


def test_router_and_aux_loss_match_jax(layer):
    jcfg, cfg, jp, tp = layer
    x = _x(cfg, 3, 29, 0).reshape(-1, cfg.d_model)
    jw, jids, jprobs = jmoe._router_probs(jp, jnp.asarray(x), jcfg)
    tw, tids, tprobs = tmoe._router_probs(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    close(tw, jw)
    close(tprobs, jprobs)
    close(tmoe._aux_loss(tprobs, tids, cfg),
          jmoe._aux_loss(jprobs, jids, jcfg))


def test_router_ties_take_the_lower_expert_first(layer):
    """Experts with identical router columns tie exactly; a zero token ties
    every expert. Both packages pick the lower ids, in order."""
    jcfg, cfg, jp, tp = layer
    E = cfg.moe.num_experts
    rng = np.random.default_rng(1)
    col = rng.standard_normal((cfg.d_model, 1)).astype(np.float32)
    other = rng.standard_normal((cfg.d_model, 1)).astype(np.float32) * 0.1
    router = np.concatenate([other] + [col] * (E - 1), axis=1)
    x = rng.standard_normal((8, cfg.d_model)).astype(np.float32)
    x[0] = 0.0
    jw, jids, _ = jmoe._router_probs({"router": jnp.asarray(router)},
                                     jnp.asarray(x), jcfg)
    tw, tids, _ = tmoe._router_probs({"router": torch.from_numpy(router)},
                                     torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tids[0].tolist() == list(range(cfg.moe.top_k))
    close(tw, jw)


@pytest.mark.parametrize("B,S", [(1, 1), (2, 7), (2, 40)])
def test_dense_dispatch_matches_jax(layer, B, S):
    """(2, 40): 80 tokens, more than one dense-dispatch slice."""
    jcfg, cfg, jp, tp = layer
    x = _x(cfg, B, S, 2)
    jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg, mode="dense")
    tout, taux = tmoe.moe_forward(tp, torch.from_numpy(x), cfg, mode="dense")
    assert tout.shape == (B, S, cfg.d_model) and tout.dtype == torch.float32
    close(tout, jout)
    close(taux, jaux)


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_capacity_dispatch_matches_jax(layer, cf):
    """cf 0.5 and 1.25 drop tokens past an expert's capacity; 4.0 keeps
    them all and then equals the dense dispatch."""
    jcfg, cfg, jp, tp = layer
    x = _x(cfg, 2, 13, 3)
    jout, _ = jmoe.moe_forward(jp, jnp.asarray(x), jcfg, mode="capacity",
                               capacity_factor=cf)
    tout, _ = tmoe.moe_forward(tp, torch.from_numpy(x), cfg,
                               mode="capacity", capacity_factor=cf)
    close(tout, jout)
    dense, _ = tmoe.moe_forward(tp, torch.from_numpy(x), cfg)
    if cf == 4.0:
        close(tout, dense)
    else:
        assert not torch.allclose(tout, dense)


def test_unknown_mode_and_mesh_dispatch_raise(layer):
    _, cfg, _, tp = layer
    x = torch.zeros((1, 2, cfg.d_model))
    with pytest.raises(ValueError, match="moe mode"):
        tmoe.moe_forward(tp, x, cfg, mode="megablox")
    with pytest.raises(NotImplementedError, match="mesh"):
        tmoe._capacity_shard_map(tp, x[0], cfg, 1.25)
