"""The PyTorch port's Mamba2 block (``repro_torch.models.ssm``) against the
JAX reference (``repro.models.ssm``) on the CPU.

Reduced mamba2-370m in f32 (d_model 256, d_state 16, head_dim 32, chunk
64); weights from the reference's ``init_mamba`` with ``A_log``, ``D``,
``dt_bias`` and ``conv_b`` redrawn with numpy (the reference initializes
them to constants), inputs drawn with numpy from a seed. The chunked
prefill is held at S 1, 2, 3, 5, 63, 64, 65 and 130 (one chunk, chunk
edges, an odd S that runs with chunk 1, many chunks), the decode step on
its own, and prefill + decode against the reference's token-by-token
decode from an empty cache — the only reference path that works for
prompts shorter than d_conv − 1 = 3 (its prefill's conv tail slice wraps
there; ROADMAP.md records it as reference behaviour). f32 to 1e-5
relative, plus 1e-6 of the largest magnitude for entries that cancel to
near zero.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

ARCH = "mamba2-370m"
J_FWD = jax.jit(jssm.mamba_forward, static_argnums=2,
                static_argnames=("return_state",))
J_STEP = jax.jit(jssm.mamba_decode_step, static_argnums=3)


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@functools.lru_cache(maxsize=None)
def _layer():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = dict(jssm.init_mamba(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(0)
    H = jp["A_log"].shape[0]
    jp["A_log"] = jnp.asarray(rng.uniform(-1, 1, H).astype(np.float32))
    jp["D"] = jnp.asarray(rng.uniform(0.5, 1.5, H).astype(np.float32))
    jp["dt_bias"] = jnp.asarray(rng.uniform(-2, 0, H).astype(np.float32))
    jp["conv_b"] = jnp.asarray(
        0.1 * rng.standard_normal(jp["conv_b"].shape).astype(np.float32))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, cfg, jp, tp


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _token_by_token(jcfg, jp, x):
    """The reference's recurrent decode over every position of x from an
    empty cache: (outputs (B, S, d), final cache)."""
    cache = jssm.init_ssm_cache(jcfg, x.shape[0])
    ys = []
    for t in range(x.shape[1]):
        y, cache = J_STEP(jp, jnp.asarray(x[:, t:t + 1]), cache, jcfg)
        ys.append(np.asarray(y))
    return np.concatenate(ys, axis=1), cache


def test_params_have_the_reference_shapes_and_dtypes():
    jcfg, cfg, jp, _ = _layer()
    own = tssm.init_mamba(torch.Generator().manual_seed(0), cfg)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(own)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")


@pytest.mark.parametrize("S", [1, 2, 3, 5, 63, 64, 65, 130])
def test_forward_matches_jax(S):
    """The chunked prefill's output equals the reference's; its decode
    cache equals the reference's prefill cache where that one is sound
    (S ≥ 3), and the reference's token-by-token cache at every S."""
    jcfg, cfg, jp, tp = _layer()
    x = _x(cfg, 2, S)
    ty, tc = tssm.mamba_forward(tp, torch.from_numpy(x), cfg,
                                return_state=True)
    assert tc["conv"].shape == (2, cfg.ssm.d_conv - 1, tc["conv"].shape[2])
    if S >= cfg.ssm.d_conv - 1:
        jy, jc = J_FWD(jp, jnp.asarray(x), jcfg, return_state=True)
        close(tc["conv"], jc["conv"])
        close(tc["state"], jc["state"])
    else:
        jy = J_FWD(jp, jnp.asarray(x), jcfg)
    close(ty, jy)
    if S <= 65:
        _, jc = _token_by_token(jcfg, jp, x)
        close(tc["conv"], jc["conv"])
        close(tc["state"], jc["state"])


def test_decode_step_matches_jax():
    jcfg, cfg, jp, tp = _layer()
    rng = np.random.default_rng(2)
    cache = jssm.init_ssm_cache(jcfg, 3)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in cache.items()}
    x = _x(cfg, 3, 1, seed=3)
    jy, jc = J_STEP(jp, jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in cache.items()}, jcfg)
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ty, tc2 = tssm.mamba_decode_step(tp, torch.from_numpy(x), tc, cfg)
    assert tc2 is tc                                    # written in place
    close(ty, jy)
    close(tc["conv"], jc["conv"])
    close(tc["state"], jc["state"])


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5])
def test_short_prompts_continue_like_token_by_token(S):
    """Prefill of S positions, then 4 decode steps, equals the reference's
    token-by-token decode of all S + 4 positions from an empty cache —
    also at S 1 and 2, where the reference's own prefill cache breaks."""
    jcfg, cfg, jp, tp = _layer()
    x = _x(cfg, 2, S + 4, seed=4)
    want, _ = _token_by_token(jcfg, jp, x)
    xt = torch.from_numpy(x)
    y, cache = tssm.mamba_forward(tp, xt[:, :S], cfg, return_state=True)
    ys = [y]
    for t in range(S, S + 4):
        y, cache = tssm.mamba_decode_step(tp, xt[:, t:t + 1], cache, cfg)
        ys.append(y)
    close(torch.cat(ys, dim=1), want)
