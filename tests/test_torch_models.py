"""The PyTorch port's dense model against the JAX reference on the CPU.

The reference initializes reduced qwen2-1.5b, yi-6b and qwen3-8b (qk-norm)
in f32; the port takes the same weights through ``repro_torch.convert``.
Prefill logits, the returned cache, the contiguous and paged decode steps
and the speculative verify (``decode_verify[_paged]``, write-ahead past the
region dropped or sent to the trash page) agree to 1e-4, and greedy tokens
are equal.
"""
import types
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as jmdl
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as mdl

torch.set_num_threads(1)

ARCHS = ["qwen2-1.5b", "yi-6b", "qwen3-8b"]
# the reference's functions, jitted once per config so repeated steps reuse
# one compiled program
J_FORWARD = jax.jit(jmdl.forward, static_argnums=1,
                    static_argnames=("return_cache", "q_chunk",
                                     "logits_last_only"))
J_DECODE = jax.jit(jmdl.decode_step, static_argnums=2)
J_DECODE_PAGED = jax.jit(jmdl.decode_step_paged, static_argnums=2)
J_VERIFY = jax.jit(jmdl.decode_verify, static_argnums=2)
J_VERIFY_PAGED = jax.jit(jmdl.decode_verify_paged, static_argnums=2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, JAX params, port params) for one reduced f32 architecture."""
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    assert asdict(cfg) == asdict(jcfg)
    jp = jmdl.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")
    return jcfg, cfg, jp, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab, size=(B, S)).astype(np.int32)


def test_config_copies_match_the_reference():
    from repro.configs import list_archs as jlist
    from repro_torch.configs import list_archs
    assert list_archs() == jlist()
    for a in list_archs():
        assert asdict(get_config(a)) == asdict(jget_config(a))
        assert asdict(get_config(a).reduced()) == \
            asdict(jget_config(a).reduced())


def test_param_tree_matches_the_reference(pair):
    jcfg, cfg, jp, tp = pair
    own = mdl.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(own)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    assert mdl.param_count(own) == jmdl.param_count(jp)


def test_forward_matches_jax(pair):
    jcfg, cfg, jp, tp = pair
    toks = _tokens(cfg, 2, 24)
    jl, _, jc = J_FORWARD(jp, jcfg, tokens=jnp.asarray(toks),
                             return_cache=True, q_chunk=8)
    tl, _, tc = mdl.forward(tp, cfg, tokens=torch.from_numpy(toks),
                            return_cache=True, q_chunk=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["l0"][k].numpy(),
                                   np.asarray(jc["l0"][k]), **TOL)
    # serving prefill: one position per row, scalar and per-row last_pos
    for last in (np.int32(13), np.array([5, 23], np.int32)):
        jl, _ = J_FORWARD(jp, jcfg, tokens=jnp.asarray(toks),
                             logits_last_only=True,
                             last_pos=jnp.asarray(last), q_chunk=64)
        tl, _ = mdl.forward(tp, cfg, tokens=torch.from_numpy(toks),
                            logits_last_only=True,
                            last_pos=torch.as_tensor(last), q_chunk=64)
        assert tl.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _junk_cache(shape_tree, seed):
    rng = np.random.default_rng(seed)
    return {n: {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
                for k, v in layer.items()} for n, layer in shape_tree.items()}


def test_decode_step_matches_jax(pair):
    """Contiguous decode with per-slot positions over a cache whose earlier
    positions hold the same random values on both sides."""
    jcfg, cfg, jp, tp = pair
    B, W = 3, 32
    cache = _junk_cache(jmdl.init_decode_cache(jcfg, B, W), 1)
    jc = jax.tree.map(jnp.asarray, cache)
    tc = jax.tree.map(torch.from_numpy, cache)
    tok = np.array([5, 41, 88], np.int32)
    pos = np.array([3, 9, 17], np.int32)
    for _ in range(4):
        jl, jc = J_DECODE(jp, jc, jcfg, tokens=jnp.asarray(tok)[:, None],
                                  pos=jnp.asarray(pos))
        tl, tc = mdl.decode_step(tp, tc, cfg,
                                 tokens=torch.from_numpy(tok)[:, None],
                                 pos=torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, 0], axis=-1)).astype(np.int32)
        assert np.array_equal(tl[:, 0].argmax(-1).numpy(), tok)
        pos = pos + 1
    np.testing.assert_allclose(tc["l0"]["k"].numpy(),
                               np.asarray(jc["l0"]["k"]), **TOL)
    # scalar position: the classic same-age batch
    jl, _ = J_DECODE(jp, jc, jcfg, tokens=jnp.asarray(tok)[:, None],
                             pos=jnp.int32(20))
    tl, _ = mdl.decode_step(tp, tc, cfg, tokens=torch.from_numpy(tok)[:, None],
                            pos=20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_decode_step_paged_matches_jax(pair):
    jcfg, cfg, jp, tp = pair
    P, ps = 9, 8
    cache = _junk_cache(jmdl.init_paged_cache(jcfg, P, ps), 2)
    jc = jax.tree.map(jnp.asarray, cache)
    tc = jax.tree.map(torch.from_numpy, cache)
    pt = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    tok = np.array([7, 61, 3], np.int32)
    pos = np.array([4, 11, 0], np.int32)      # row 2 idles on the trash page
    for _ in range(4):
        jl, jc = J_DECODE_PAGED(
            jp, jc, jcfg, tokens=jnp.asarray(tok)[:, None],
            page_table=jnp.asarray(pt), pos=jnp.asarray(pos))
        tl, tc = mdl.decode_step_paged(
            tp, tc, cfg, tokens=torch.from_numpy(tok)[:, None],
            page_table=torch.from_numpy(pt), pos=torch.from_numpy(pos))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
        tok = np.asarray(jnp.argmax(jl[:, 0], axis=-1)).astype(np.int32)
        pos = pos + 1
    for k in ("k", "v"):      # the trash page's contents are unspecified
        np.testing.assert_allclose(tc["l0"][k][:, 1:].numpy(),
                                   np.asarray(jc["l0"][k])[:, 1:], **TOL)


def test_greedy_tokens_match_jax(pair):
    """Prefill then greedy decode, as the gateway's per-request path."""
    jcfg, cfg, jp, tp = pair
    toks = _tokens(cfg, 2, 8, seed=3)
    steps = 8

    jl, _, jc = J_FORWARD(jp, jcfg, tokens=jnp.asarray(toks),
                             logits_last_only=True, return_cache=True)
    jc = jax.tree.map(lambda a: jnp.pad(
        a, ((0, 0), (0, 0), (0, 0), (0, steps), (0, 0))), jc)
    tl, _, tc = mdl.forward(tp, cfg, tokens=torch.from_numpy(toks),
                            logits_last_only=True, return_cache=True)
    from repro_torch.serve.kv_cache import extend_cache
    tc = extend_cache(tc, 8 + steps)
    jt, tt = [], []
    jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = tl[:, -1].argmax(-1)[:, None].int()
    for t in range(steps):
        jt.append(np.asarray(jtok[:, 0]))
        tt.append(ttok[:, 0].numpy())
        jl, jc = J_DECODE(jp, jc, jcfg, tokens=jtok, pos=8 + t)
        tl, tc = mdl.decode_step(tp, tc, cfg, tokens=ttok, pos=8 + t)
        jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        ttok = tl[:, -1].argmax(-1)[:, None].int()
    np.testing.assert_array_equal(np.stack(tt, 1), np.stack(jt, 1))


def test_qk_norm_scales_match_jax():
    """qk-norm with non-unit scales (the init's are ones): the per-head
    RMSNorm of q and k before RoPE, in prefill and decode."""
    jcfg = jget_config("qwen3-8b").reduced()
    cfg = get_config("qwen3-8b").reduced()
    assert cfg.qk_norm
    jp = jmdl.init_params(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(4)
    mixer = jp["blocks"]["l0"]["mixer"]
    for name in ("q_norm", "k_norm"):
        scale = mixer[name]["scale"]
        assert scale.shape == (cfg.n_layers, cfg.head_dim)
        mixer[name]["scale"] = jnp.asarray(
            rng.uniform(0.5, 1.5, scale.shape).astype(np.float32))
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")
    toks = _tokens(cfg, 2, 16, seed=4)
    jl, _, jc = J_FORWARD(jp, jcfg, tokens=jnp.asarray(toks),
                          return_cache=True, q_chunk=8)
    tl, _, tc = mdl.forward(tp, cfg, tokens=torch.from_numpy(toks),
                            return_cache=True, q_chunk=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["l0"]["k"].numpy(),
                               np.asarray(jc["l0"]["k"]), **TOL)
    cache = _junk_cache(jmdl.init_decode_cache(jcfg, 2, 24), 5)
    tok, pos = np.array([3, 9], np.int32), np.array([16, 7], np.int32)
    jl, _ = J_DECODE(jp, jax.tree.map(jnp.asarray, cache), jcfg,
                     tokens=jnp.asarray(tok)[:, None], pos=jnp.asarray(pos))
    tl, _ = mdl.decode_step(tp, jax.tree.map(torch.from_numpy, cache), cfg,
                            tokens=torch.from_numpy(tok)[:, None],
                            pos=torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_decode_verify_matches_jax(pair):
    """The slot-pool verify: T = 4 positions per row over a cache of W =
    32 holding the same junk on both sides. Row 2 starts at 30, so its
    offsets 2 and 3 fall past the pool: they must be dropped, not clamped
    onto position 31. The logits also match the port's own one-token
    decode chain over the same tokens."""
    jcfg, cfg, jp, tp = pair
    B, W, T = 3, 32, 4
    cache = _junk_cache(jmdl.init_decode_cache(jcfg, B, W), 6)
    toks = _tokens(cfg, B, T, seed=6)
    pos = np.array([3, 17, 30], np.int32)
    jl, jc = J_VERIFY(jp, jax.tree.map(jnp.asarray, cache), jcfg,
                      tokens=jnp.asarray(toks), pos=jnp.asarray(pos))
    tc = jax.tree.map(torch.from_numpy, cache)
    tl, tc = mdl.decode_verify(tp, tc, cfg, tokens=torch.from_numpy(toks),
                               pos=pos)
    assert tl.shape == (B, T, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["l0"][k].numpy(),
                                   np.asarray(jc["l0"][k]), **TOL)
    # offset 1 of row 2 landed at 31 and nothing overwrote it; below the
    # rows' windows the junk is untouched
    seq = jax.tree.map(torch.from_numpy, cache)
    for t in range(T):
        sl, seq = mdl.decode_step(tp, seq, cfg,
                                  tokens=torch.from_numpy(toks[:, t:t + 1]),
                                  pos=torch.from_numpy(pos + t))
        keep = pos + t < W
        np.testing.assert_allclose(sl[keep, 0].numpy(),
                                   tl[keep, t].numpy(), **TOL)
    np.testing.assert_array_equal(tc["l0"]["k"][:, 2, :, :30].numpy(),
                                  cache["l0"]["k"][:, 2, :, :30])
    np.testing.assert_allclose(tc["l0"]["k"][:, 2, :, 31].numpy(),
                               seq["l0"]["k"][:, 2, :, 31].numpy(), **TOL)


def test_decode_verify_paged_matches_jax(pair):
    """The paged verify: a window past the table's extent (row 0: 29–32,
    npg · ps = 32), one crossing a page boundary (row 1), one running into
    a block whose table entry is 0 (row 2), and an idle row on the trash
    page. Every live page agrees with the reference's, and so does every
    logit whose attention reads no trash page."""
    jcfg, cfg, jp, tp = pair
    P, ps, T = 10, 8, 4
    cache = _junk_cache(jmdl.init_paged_cache(jcfg, P, ps), 7)
    pt = np.array([[1, 2, 3, 4], [5, 6, 7, 9], [8, 0, 0, 0],
                   [0, 0, 0, 0]], np.int32)
    toks = _tokens(cfg, 4, T, seed=7)
    pos = np.array([29, 22, 6, 0], np.int32)
    jl, jc = J_VERIFY_PAGED(jp, jax.tree.map(jnp.asarray, cache), jcfg,
                            tokens=jnp.asarray(toks),
                            page_table=jnp.asarray(pt), pos=jnp.asarray(pos))
    tc = jax.tree.map(torch.from_numpy, cache)
    tl, tc = mdl.decode_verify_paged(tp, tc, cfg,
                                     tokens=torch.from_numpy(toks),
                                     page_table=pt, pos=pos)
    # the trash page's contents are unspecified: rows 2 (offsets 2, 3)
    # and 3 read it
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
    np.testing.assert_allclose(tl[2, :2].numpy(), np.asarray(jl)[2, :2],
                               **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["l0"][k][:, 1:].numpy(),
                                   np.asarray(jc["l0"][k])[:, 1:], **TOL)
    # page 8 keeps its junk below row 2's window (offsets 0–5)
    np.testing.assert_array_equal(tc["l0"]["k"][:, 8, :, :6].numpy(),
                                  cache["l0"]["k"][:, 8, :, :6])


def test_bf16_weights_convert_bit_for_bit():
    jcfg = jget_config("qwen2-1.5b").reduced()
    import dataclasses
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16", n_layers=1)
    cfg = get_config("qwen2-1.5b").reduced()
    cfg = dataclasses.replace(cfg, dtype="bfloat16", n_layers=1)
    jp = jmdl.init_params(jax.random.PRNGKey(1), jcfg)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")
    a = np.asarray(jp["blocks"]["l0"]["mixer"]["wq"])
    b = tp["blocks"]["l0"]["mixer"]["wq"]
    assert b.dtype == torch.bfloat16
    np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                  a.view(np.int16))
    with pytest.raises(ValueError, match="runs in"):
        convert.model_params_from_numpy(
            jax.tree.map(np.asarray, jp),
            dataclasses.replace(cfg, dtype="float32"), device="cpu")


def test_unported_architectures_raise():
    """Every arch initializes now (tests/test_torch_archs.py holds them
    against the reference), the MoE's expert-parallel dispatch included:
    outside logical-axis rules it raises TypeError, as the reference's
    does (its mesh runs are tests/test_torch_serving_mesh.py's). SSM state
    has no pages, so the paged pool refuses SSM and hybrid archs, as the
    reference does."""
    from repro_torch import sharding as shd
    from repro_torch.models import moe
    for arch in ("phi3.5-moe-42b-a6.6b", "mamba2-370m"):
        cfg = get_config(arch).reduced()
        params = mdl.init_params(0, cfg, device="cpu")
        if cfg.moe is not None:
            ffn = {k: v[0] for k, v in params["blocks"]["l0"]["ffn"].items()}
            xt = torch.zeros((2, cfg.d_model))
            with pytest.raises(TypeError, match="use_rules"):
                moe._capacity_shard_map(ffn, xt, cfg, 1.25)
            # rules without an experts axis: the single-block dispatch
            mesh = types.SimpleNamespace(shape={"data": 1})
            with shd.use_rules(mesh, {"tokens": "data"}):
                got = moe._capacity_shard_map(ffn, xt, cfg, 1.25)
            tw, ti, pr = moe._router_probs(ffn, xt, cfg)
            assert torch.equal(got[0], moe._capacity_dispatch(
                ffn, xt, tw, ti, cfg, 1.25))
        else:
            with pytest.raises(TypeError, match="paged"):
                mdl.init_paged_cache(cfg, 4, 8, device="cpu")
